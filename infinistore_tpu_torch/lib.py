"""Public Python API: InfinityConnection + server control.

Copy of ``infinistore_tpu/lib.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step. One deliberate difference:
``_extract_ptr_size`` refuses a tensor that does not live on the CPU (the
native client would ``memcpy`` from a device pointer).

TPU-native rebuild of the reference's infinistore/lib.py (surface parity:
InfinityConnection :288, register_server :203, evict_cache :232,
purge_kv_map/get_kvmap_len :177-201, Logger :155, exceptions :30-35). The
asyncio bridging keeps the reference's architecture — a native background
thread completes operations, with a BoundedSemaphore(128) inflight cap
(reference lib.py:307) — but replaces its per-op call_soon_threadsafe hop
(reference lib.py:462-470) with an eventfd completion ring the event loop
drains through its own epoll (one wake can complete a whole batch, and the
native reactor never acquires the GIL). The native side is the epoll/DCN
reactor in native/src/client.cpp instead of an ibverbs CQ thread, and the
server runs its own reactor thread instead of being grafted onto uvloop (no
uvloop/PyCapsule dance needed).
"""

import asyncio
import ctypes
import functools
import itertools
import json
import os
import socket
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np

from . import telemetry, tracing, wire
from .wire import PRIORITY_BACKGROUND, PRIORITY_FOREGROUND  # noqa: F401 (re-export)
from ._native import COMPLETION_CB, LOG_SINK_CB, lib
from .config import (  # noqa: F401  (re-exported reference names)
    LINK_DCN,
    LINK_ETHERNET,
    LINK_IB,
    LINK_ICI,
    TYPE_DCN,
    TYPE_RDMA,
    TYPE_TCP,
    ClientConfig,
    ServerConfig,
)

_LOG_LEVELS = {"debug": 0, "info": 1, "warning": 2, "error": 3, "off": 4}


class InfiniStoreException(Exception):
    """Generic store error (reference lib.py:30)."""


class InfiniStoreKeyNotFound(InfiniStoreException):
    """Typed miss for read paths (reference lib.py:33)."""


class InfiniStoreResourcePressure(InfiniStoreException):
    """The store could not serve the op RIGHT NOW (507): e.g. a batch read
    whose promoted spill blocks exceed RAM. The data survives — retry
    smaller/later, or recompute; distinct from InfiniStoreKeyNotFound
    (data absent) and from transport failure (base class)."""


class InfiniStoreColdTier(InfiniStoreResourcePressure):
    """The key is PRESENT but demoted — alive in the spill tier, and the
    server's RAM is too pressured to promote it for this op (the typed
    512 status, docs/tiering.md): "cold but alive". A subclass of
    :class:`InfiniStoreResourcePressure` so every existing pressure
    handler keeps working; tier-aware callers catch it first to count a
    DEMOTION HIT instead of a miss (tiering.note_demotion_hit) and to
    retry smaller / read the root through the pooled cold tier instead
    of recomputing."""


class InfiniStoreNoMatch(InfiniStoreException):
    """get_match_last_index found no matching prefix — a semantic miss,
    distinct from a transport/timeout failure (which raises the base
    InfiniStoreException). The reference conflates the two in one generic
    exception (reference lib.py:575-577); connectors need the split so a
    dead store is not mistaken for a cache miss."""


class Logger:
    """Log facade over the native sink (reference Logger, lib.py:155-174).

    Structured trace context (docs/observability.md): a line emitted while
    an op span is active carries ``trace_id=``/``span=`` (and ``member=``
    on cluster-routed paths, from the span's ``cluster_member``
    annotation), so grep-by-trace-id crosses logs, ``GET /trace`` and
    ``GET /events``. Costs one module-bool check when tracing is off.
    """

    @staticmethod
    def with_context(msg) -> str:
        """``msg`` suffixed with the active span's trace context (verbatim
        when tracing is off or no span is bound)."""
        text = str(msg)
        span = tracing.active_span()
        if span is None:
            return text
        text += f" trace_id={span.trace_id:#x} span={span.span_id:#x}"
        member = span.attrs.get("cluster_member")
        if member is not None:
            text += f" member={member}"
        return text

    @staticmethod
    def debug(msg):
        """Log at debug level through the native sink."""
        lib.its_log(0, Logger.with_context(msg).encode())

    @staticmethod
    def info(msg):
        """Log at info level through the native sink."""
        lib.its_log(1, Logger.with_context(msg).encode())

    @staticmethod
    def warn(msg):
        """Log at warning level through the native sink."""
        lib.its_log(2, Logger.with_context(msg).encode())

    @staticmethod
    def error(msg):
        """Log at error level through the native sink."""
        lib.its_log(3, Logger.with_context(msg).encode())

    @staticmethod
    def set_log_level(level: str):
        """Set the process-wide level: debug|info|warning|error|off."""
        lib.its_set_log_level(_LOG_LEVELS[level.lower()])


# Env override, as the reference honors INFINISTORE_LOG_LEVEL (lib.py:62-65).
_env_level = os.environ.get("INFINISTORE_TPU_LOG_LEVEL") or os.environ.get(
    "INFINISTORE_LOG_LEVEL"
)
if _env_level and _env_level.lower() in _LOG_LEVELS:
    Logger.set_log_level(_env_level)


def _resolve_hostname(hostname: str) -> str:
    """Resolve to an IPv4 address (reference lib.py:336-353)."""
    try:
        return socket.gethostbyname(hostname)
    except socket.gaierror as e:
        raise InfiniStoreException(f"cannot resolve host {hostname!r}: {e}") from e


# ---------------------------------------------------------------------------
# Async completion plumbing. Primary path (Linux): the native reactor pushes
# (token, status) into a per-connection completion ring and signals an
# eventfd; the asyncio loop wakes through its own epoll (add_reader) and
# drains the WHOLE ring in one pass — no per-op GIL acquisition on the
# reactor thread and no per-op call_soon_threadsafe hop (measured ~28us
# round-trip on a single-core host vs ~21us for an eventfd wake). Fallback
# (no os.eventfd): one shared ctypes callback + call_soon_threadsafe per op.
# Both paths resolve tokens through the same registry.
# ---------------------------------------------------------------------------

_completions: dict = {}
_completion_token = itertools.count(1)
_HAS_EVENTFD = hasattr(os, "eventfd")
_DRAIN_CAP = 256
_NULL_CB = ctypes.cast(None, COMPLETION_CB)  # ring-mode submits pass no callback

# Adaptive bridge poll budget (seconds) — the Python twin of the native
# kRingPoll* constants (native/include/its/ring.h): a ring-mode waiter spins
# draining the completion ring for min(2 x gap-EWMA, cap) before parking on
# the eventfd; an EWMA beyond the cap means completions are slow enough that
# the wakeup latency is noise, so park immediately (budget 0) and burn no CPU.
_POLL_CAP_S = 200e-6
_POLL_MIN_S = 5e-6
_POLL_DEFAULT_S = 50e-6

# Distinct (keys, offsets) layouts kept per connection by the descriptor
# marshalling cache (_marshal_batch) — a handful covers the steady-state
# reuse pattern (same block table resubmitted op after op) while bounding
# memory to ~tens of KB per layout.
_MARSHAL_CACHE_CAP = 8


def _poll_budget_s(ewma_gap_s: float) -> float:
    """min(2 x EWMA, cap), clamped up to the floor; default with no samples;
    0 (park immediately) when the EWMA says completions arrive slowly."""
    if ewma_gap_s == 0.0:
        return _POLL_DEFAULT_S
    if ewma_gap_s > _POLL_CAP_S:
        return 0.0
    return min(max(2.0 * ewma_gap_s, _POLL_MIN_S), _POLL_CAP_S)

# ---------------------------------------------------------------------------
# Process-wide QoS foreground gate. On a shared host every byte of a
# BACKGROUND op costs CPU (its submitter's Python/asyncio work, its reactor
# thread, the GIL) that a concurrent FOREGROUND op's completion chain needs
# — measured: a background save flood inflates an innocent 4KB sync read's
# p99 ~10x even when the SERVER serves it in ~30us, because the tail lives
# in the client process, not the store. The server's two-level slice
# scheduler cannot see that; this gate can: FOREGROUND batched ops register
# here for their in-flight window (plain int increments — GIL-atomic), and
# BACKGROUND ops across ALL connections in the process defer their next
# sub-batch while any foreground op is in flight, bounded by _BG_AGING_S
# (the same starvation-proof aging escape the server applies to slices).
# The wait is a condition variable, not a poll: asyncio.sleep bottoms out at
# epoll's millisecond timeout resolution, so a polling gate would hand
# background a ~1ms re-entry lag per foreground op (measured ~23% of its
# throughput under a decode-wave load); the condition wakes waiters within
# the executor-handoff cost instead, and the foreground fast path pays two
# uncontended lock ops only.
# ---------------------------------------------------------------------------
# Concurrency contract (ITS-R, docs/static_analysis.md): all four gate
# globals are guarded by _fg_cond's lock — every reader and writer below
# holds it, and _fg_gate_closed's lock-free read is the one audited
# exception (a stale verdict only costs one extra executor hop). The
# class-scoped ITS-R001 pass does not cover module globals; this block is
# covered by the loop_block AUDITED seed + the qos isolation tests.
_fg_inflight = 0  # foreground batched ops currently in flight, process-wide
_fg_last_exit = 0.0  # monotonic stamp of the last foreground completion
_fg_cond = threading.Condition()
_bg_waiters = 0
# Dedicated tiny pool for gate waits: blocking them on the loop's DEFAULT
# executor would let a handful of deferring background saves occupy every
# worker and queue the engine's compute offloads behind a QoS wait. A
# waiter queued here past its deadline just returns aged immediately when
# a worker frees — the aging bound holds either way. Lazy: most processes
# never tag a background op.
_gate_pool = None


def _gate_executor():
    global _gate_pool
    if _gate_pool is None:
        import concurrent.futures

        _gate_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="its-qos-gate"
        )
    return _gate_pool
_BG_AGING_S = 0.05  # max one bg sub-batch defers to the gate before proceeding
# Hysteresis: foreground arrives in waves (an engine step fetches several
# blocks back-to-back), and between two reads of one wave _fg_inflight
# flickers to zero for tens of microseconds — releasing on the flicker
# would resume background work exactly into the wave's remaining reads
# (measured: it erases most of the isolation). The gate therefore stays
# closed for a short cooldown after the LAST foreground exit.
_BG_COOLDOWN_S = 0.0004


def _fg_gate_closed() -> bool:
    return bool(
        _fg_inflight or (time.monotonic() - _fg_last_exit) < _BG_COOLDOWN_S
    )


def _fg_gate_enter():
    global _fg_inflight
    with _fg_cond:
        _fg_inflight += 1


def _fg_gate_exit():
    global _fg_inflight, _fg_last_exit
    with _fg_cond:
        _fg_inflight -= 1
        if _fg_inflight == 0:
            _fg_last_exit = time.monotonic()
            if _bg_waiters:
                _fg_cond.notify_all()


def _bg_gate_block(deadline: float) -> bool:
    """Block until the foreground gate opens (no op in flight AND the
    cooldown elapsed) or ``deadline`` passes. Returns False when the wait
    aged out (foreground still busy — the starvation escape)."""
    global _bg_waiters
    with _fg_cond:
        _bg_waiters += 1
        try:
            while True:
                now = time.monotonic()
                if now >= deadline:
                    return False
                if _fg_inflight:
                    _fg_cond.wait(deadline - now)
                    continue
                hold = _fg_last_exit + _BG_COOLDOWN_S - now
                if hold <= 0:
                    return True
                _fg_cond.wait(min(hold, deadline - now))
        finally:
            _bg_waiters -= 1


async def _bg_gate_wait(conn: "InfinityConnection"):
    """Defer a BACKGROUND sub-batch while foreground ops are in flight
    anywhere in the process (aging-bounded). The blocking condition wait
    runs in an executor so the caller's event loop keeps serving
    completions; thanks to the cooldown the release (and so the executor
    wake) lands AFTER the foreground wave, and the precise wake beats a
    sleep-poll's ~1ms resume lag (which alone costs background ~15% of a
    decode-wave workload's between-wave bandwidth)."""
    if not _fg_gate_closed():
        return
    conn._bg_deferred += 1
    deadline = time.monotonic() + _BG_AGING_S
    ok = await asyncio.get_running_loop().run_in_executor(
        _gate_executor(), _bg_gate_block, deadline
    )
    if not ok:
        conn._bg_aged += 1
        telemetry.note_qos_aged()


def _bg_gate_wait_sync(conn: "InfinityConnection"):
    """Blocking-path variant of _bg_gate_wait (sync background ops)."""
    if not _fg_gate_closed():
        return
    conn._bg_deferred += 1
    if not _bg_gate_block(time.monotonic() + _BG_AGING_S):
        conn._bg_aged += 1
        telemetry.note_qos_aged()


def _store_span(op_name: str):
    """A wire op's ``store.<op>`` span, child of the active span; None when
    tracing is off (one bool check, no allocation)."""
    if not tracing.enabled():
        return None
    return tracing.start_span("store." + op_name)


@COMPLETION_CB
def _on_complete(ctx, code):
    entry = _completions.pop(ctx or 0, None)
    if entry is None:
        return
    loop, future, on_done = entry
    loop.call_soon_threadsafe(on_done, future, code)


def _extract_ptr_size(arg, size: Optional[int]) -> Tuple[int, int]:
    """Accept an int pointer + size, a numpy array, or a (cpu) torch tensor.

    The reference registers raw pointers and torch CUDA tensors
    (lib.py:581-616); on TPU the registered region is always host memory (the
    staging pool), so numpy arrays are the first-class citizen here.
    """
    if isinstance(arg, int):
        if size is None:
            raise ValueError("size is required when registering a raw pointer")
        return arg, size
    if isinstance(arg, np.ndarray):
        if not arg.flags["C_CONTIGUOUS"]:
            raise ValueError("numpy array must be C-contiguous")
        return arg.ctypes.data, arg.nbytes
    data_ptr = getattr(arg, "data_ptr", None)
    if callable(data_ptr):  # torch tensor
        # A device tensor's data_ptr() is a device address: the native client
        # would memcpy from it. Only host memory may be registered.
        device = getattr(arg, "device", None)
        if getattr(arg, "is_cuda", False) or getattr(device, "type", "cpu") != "cpu":
            raise ValueError(
                f"register_mr: tensor lives on {device}, not the CPU; stage it "
                "to host memory first"
            )
        nbytes = arg.element_size() * arg.nelement()
        return data_ptr(), nbytes
    raise NotImplementedError(f"register_mr: unsupported type {type(arg)}")


def _reconnecting(ptr_arg: Optional[int] = None):
    """Retry a blocking op ONCE over a fresh connection when the previous
    one is dead and ``auto_reconnect`` is configured.

    Scope is deliberately narrow: only sync ops (all idempotent — puts
    rewrite the same bytes, control ops are reads or absolute deletes), and
    only when the native reactor reports the connection down — a timeout on
    a LIVE connection re-raises untouched (retrying would double latency and
    re-queue work on a server that is merely slow). Async batched ops are
    not wrapped: their caller owns pipelining and should call
    ``reconnect()`` itself.

    ``ptr_arg``: positional index (after self) of a raw buffer pointer. A
    retry whose buffer lived in a now-unmapped shm segment of the OLD
    connection would touch unmapped memory — it gets a typed error telling
    the caller to reallocate via alloc_shm_mr instead.

    The reference has no reconnection at all (SURVEY.md §5.3); this is
    cache-semantics-safe recovery for the disaggregation flow, where a
    restarted store must look like a cold cache, not a dead engine."""

    def deco(method):
        @functools.wraps(method)
        def wrapper(self, *args, **kwargs):
            try:
                return method(self, *args, **kwargs)
            except InfiniStoreKeyNotFound:
                raise
            except InfiniStoreException:
                if not (
                    self.config.auto_reconnect
                    and self._ever_connected
                    and not self._closed  # close() is final; never resurrect
                    and not self.is_connected
                ):
                    raise
                Logger.warn("store connection lost; auto-reconnecting")
                self.reconnect()
                if ptr_arg is not None:
                    ptr = args[ptr_arg] if ptr_arg < len(args) else kwargs.get("ptr")
                    if isinstance(ptr, int) and self._in_dead_shm(ptr):
                        raise InfiniStoreException(
                            "reconnected, but this op's buffer was an "
                            "alloc_shm_mr view of the previous connection "
                            "(its segment is unmapped) — reallocate the "
                            "buffer via alloc_shm_mr and retry"
                        )
                return method(self, *args, **kwargs)

        return wrapper

    return deco


class InfinityConnection:
    """A connection to one store server (reference InfinityConnection,
    lib.py:288)."""

    MAX_INFLIGHT = 128  # reference BoundedSemaphore(128), lib.py:307
    # This connection can carry the two-class QoS tag (wire.PRIORITY_*) on
    # batched ops; producers gate tagging on this attribute
    # (wire.qos_kwargs) so priority degrades to FIFO on stand-ins.
    QOS_AWARE = True
    # In-flight byte budget for BACKGROUND batched ops: a bigger batch is
    # split into half-budget sub-batches pipelined two at a time, so on the
    # socket path a foreground op queues behind at most this many payload
    # bytes instead of one giant burst (on the same-host segment path the
    # server's slice scheduler preempts WITHIN an op, so the budget mostly
    # bounds the wire). Foreground (untagged) ops are never split — the
    # default path is byte-identical.
    BG_SUBBATCH_BYTES = 4 << 20

    def __init__(self, config: ClientConfig):
        config.verify()
        self.config = config
        self._handle = None
        # Per-loop inflight caps, pruned on access: every asyncio.run()
        # creates a fresh loop, and an unpruned registry would accumulate
        # dead-loop entries forever. (Weak keys alone don't work: a
        # BoundedSemaphore that ever blocked caches its loop, so the value
        # would pin its own key alive.)
        self._semaphores: dict = {}
        # Event-fd completion bridge (see module comment above).
        if _HAS_EVENTFD:
            self._efd = os.eventfd(0, os.EFD_NONBLOCK)
            self._efd_finalizer = weakref.finalize(self, os.close, self._efd)
        else:
            self._efd = None
        self._reader_loops = weakref.WeakSet()  # loops with add_reader(_efd)
        self._drain_tokens = (ctypes.c_uint64 * _DRAIN_CAP)()
        self._drain_codes = (ctypes.c_int32 * _DRAIN_CAP)()
        # Bridge-side coalescing observability: event-loop wakeups that found
        # work vs completions dispatched through them (the native side keeps
        # the matching push/signal counters — completion_stats()).
        self._drain_wakeups = 0
        self._drain_completed = 0
        # Per-tick ring batch window (docs/descriptor_ring.md): the first
        # ring-mode async submit of an event-loop iteration opens a native
        # post group and schedules _group_flush via call_soon — asyncio's
        # _run_once snapshots its ready queue at iteration start, so the
        # flush is guaranteed to run AFTER every same-tick submit, turning
        # a FetchCoalescer flush's K ops into one multi-op batch slot.
        self._group_open = False
        self._batch_windows = 0  # ring_batch_window() calls (eager opens)
        # Adaptive bridge poll (the Python twin of the reactor's
        # poll-then-park): EWMA of inter-completion gaps decides how long a
        # ring-mode waiter spins draining the completion ring before falling
        # back to the eventfd wakeup. Loop-thread-only state, like the
        # native reactor's unguarded ring_gap_ewma_us_.
        self._comp_gap_ewma = 0.0
        self._comp_last_ts = 0.0
        self._bridge_poll_hits = 0  # poll window caught the completion
        self._bridge_poll_arms = 0  # budget expired (or 0) -> eventfd park
        self._bridge_poll_drained = 0  # completions dispatched by poll drains
        # Called after a successful reconnect() — e.g. a StripedConnection
        # invalidating sibling stripes' aliases of this connection's shm
        # segments (which the reconnect just unmapped).
        self._reconnect_listeners: list = []
        # get_match_last_index encode cache (chains are append-only). One
        # tuple, swapped atomically — sync ops run from concurrent threads.
        self._match_cache: Tuple[list, bytes] = ([], b"")
        # Batched-op descriptor marshalling cache (_marshal_batch): steady-
        # state KV traffic (paged-attention block reuse, save/restore loops)
        # resubmits the SAME (keys, offsets) layout op after op, and
        # re-deriving the keys blob + ctypes offset array burns ~0.3ms of
        # client CPU per 1000-key batch — CPU that, on a shared or single
        # core, is stolen from the server's copy slices mid-op. Keyed by the
        # value-hashable (keys, offsets) tuple pair (CPython caches str
        # hashes, so a warm probe is tens of microseconds); bounded FIFO.
        # Entries are immutable and dict ops are GIL-atomic, so a race
        # between sync-op threads costs a redundant encode, never a wrong
        # blob.
        self._marshal_cache: dict = {}
        # Per-class batched-op counters [foreground, background] — the
        # client half of the QoS ledger (qos_stats()); the server half is
        # get_stats()["qos"]. _bg_deferred/_bg_aged count this connection's
        # background sub-batches held at (resp. aged past) the process-wide
        # foreground gate.
        self._qos_ops = [0, 0]
        self._bg_deferred = 0
        self._bg_aged = 0
        self._shm_bufs: list = []  # keeps alloc_shm_mr views (and mappings) alive
        self._plain_mrs: list = []  # (ptr, nbytes) re-registered on reconnect
        # (ptr, nbytes) of ANOTHER connection's shm segment registered here
        # as a plain region (StripedConnection stripes 1..N). NOT
        # re-registered on reconnect — the segment dies with its owner; the
        # ranges become dead-shm so retries get a typed error.
        self._segment_aliases: list = []
        self._ever_connected = False  # auto-reconnect only after a first connect
        self._closed = False  # explicit close() forbids auto-reconnect
        # Old native handles parked by reconnect(): destroying them there
        # could free a Connection another thread is still inside (sync ops
        # run without the GIL) — they are closed immediately (reactor stops,
        # in-flight ops fail out) but destroyed only in close().
        self._dead_handles: list = []
        # Address ranges of shm segments unmapped by reconnect(): a retried
        # op whose buffer lived there must get a clear error, not a segfault.
        self._dead_shm_ranges: list = []
        # Connection-lifecycle lock: serializes connect/reconnect/close and
        # the handle/shm bookkeeping above against ops on other threads.
        # ITS-R001 classification is audited OFF for this class
        # (races.CLASS_EXEMPT): the hot data plane is the native reactor's,
        # whose lock discipline is the GUARDED_BY annotations in
        # native/include/its/client.h (-Wthread-safety) plus TSAN.
        self._lock = threading.Lock()
        self.rdma_connected = False  # name kept for drop-in compatibility
        self.tcp_connected = False
        Logger.set_log_level(config.log_level)

    # -- lifecycle ----------------------------------------------------------

    def _new_native_handle(self):
        """Create + connect a native handle from self.config (shared by
        connect() and reconnect(); one place to grow the C signature)."""
        ip = _resolve_hostname(self.config.host_addr)
        handle = lib.its_conn_create(
            ip.encode(),
            self.config.service_port,
            self.config.connect_timeout_ms,
            1 if self.config.enable_shm else 0,
            self.config.op_timeout_ms,
            self.config.pacing_rate_mbps,
            1 if self.config.enable_ring else 0,
            self.config.ring_slots,
        )
        rc = lib.its_conn_connect(handle)
        if rc != 0:
            lib.its_conn_destroy(handle)
            raise InfiniStoreException(
                f"failed to connect to {ip}:{self.config.service_port} (rc={rc})"
            )
        if self._efd is not None:
            lib.its_conn_set_completion_fd(handle, self._efd)
        return handle

    def _mark_connected(self):
        self._ever_connected = True
        self._closed = False
        if self.config.connection_type == TYPE_RDMA:
            self.rdma_connected = True
        else:
            self.tcp_connected = True

    def connect(self):
        """Connect to the store (blocking; bounded by connect_timeout_ms).
        Attempts the same-host shm handshake when enable_shm is set."""
        self._handle = self._new_native_handle()
        self._mark_connected()

    @property
    def shm_active(self) -> bool:
        """True when the same-host shm fast path is in use for batched ops."""
        return self._handle is not None and lib.its_conn_shm_active(self._handle) == 1

    @property
    def ring_active(self) -> bool:
        """True when the descriptor-ring data plane is posting batched
        segment ops as shared-memory descriptors (docs/descriptor_ring.md);
        False degrades to the byte-identical socket path."""
        return self._handle is not None and lib.its_conn_ring_active(self._handle) == 1

    def ring_name(self) -> str:
        """Shm name of this connection's descriptor-ring segment (empty when
        the ring is inactive) — the introspection hook the torn-descriptor
        tests use to map and tamper with the ring from outside the client."""
        if self._handle is None:
            return ""
        buf = ctypes.create_string_buffer(128)
        n = lib.its_conn_ring_name(self._handle, buf, len(buf))
        return buf.raw[:n].decode() if n > 0 else ""

    async def connect_async(self):
        """connect() off the event loop thread (reference connect_async)."""
        await asyncio.to_thread(self.connect)

    def close(self):
        """Tear down the connection: stops the native reactor, unmaps shm
        segments (invalidating alloc_shm_mr views), releases registrations.
        ``close_connection`` is the reference-compatible alias."""
        leftovers: list = []
        with self._lock:  # serialized against reconnect()/register_mr()
            self._closed = True  # a closed connection must stay closed
            if self._handle is not None:
                lib.its_conn_close(self._handle)
                # its_conn_close failed every in-flight op into the ring;
                # collect them before the handle (and its ring) is freed.
                leftovers += self._drain_ring_locked(self._handle)
                lib.its_conn_destroy(self._handle)
                self._handle = None
                self._group_open = False  # pending _group_flush no-ops on None
                self._shm_bufs.clear()  # views die once the segment unmaps
                self._plain_mrs.clear()
                self._segment_aliases.clear()
                self.rdma_connected = False
                self.tcp_connected = False
            for h in self._dead_handles:  # parked by reconnect(); see __init__
                leftovers += self._drain_ring_locked(h)
                lib.its_conn_destroy(h)
            self._dead_handles.clear()
            self._dead_shm_ranges.clear()
            readers = list(self._reader_loops)
            self._reader_loops = weakref.WeakSet()
        self._dispatch_completions(leftovers)
        for loop in readers:
            try:
                loop.call_soon_threadsafe(self._remove_reader, loop)
            except RuntimeError:
                pass  # loop already closed; its selector died with it

    def _remove_reader(self, loop):
        try:
            loop.remove_reader(self._efd)
        except (OSError, ValueError):
            pass

    # reference name (lib.py:380)
    close_connection = close

    @property
    def is_connected(self) -> bool:
        """Liveness as the native reactor sees it: False once the socket
        died or fail_all ran, even if close() was never called."""
        return self._handle is not None and lib.its_conn_connected(self._handle) == 1

    def reconnect(self):
        """Tear down and re-establish the connection, re-registering every
        plain memory region (register_mr) on the new one.

        alloc_shm_mr views do NOT survive: their segments die with the old
        connection, and touching an old view afterwards is undefined —
        reallocate them (a retried sync op whose buffer lived there gets a
        typed error instead). A restarted server comes back EMPTY (the
        store is a cache, reference kv_map is in-RAM only): after
        reconnect, misses mean recompute, exactly like a cold cache.

        A FAILED reconnect (server still down) leaves the OLD handle and
        all bookkeeping untouched — fully retryable. The new connection is
        built FIRST and swapped in only on success, so ``_handle`` is never
        None mid-reconnect: a concurrent thread between its own liveness
        check and its native call uses either the old handle (its op fails
        out when that handle closes) or the new one — never NULL. The old
        handle is closed after the swap (in-flight ops fail out) but
        destroyed only at close(), so it is never freed under a live call."""
        leftovers: list = []
        with self._lock:
            if self._closed:  # checked under the lock: close() is final
                raise InfiniStoreException("connection closed; create a new one")
            if self.is_connected:
                return  # another thread already reconnected
            # Build the replacement FIRST (raises on failure, state intact).
            new_handle = self._new_native_handle()
            mrs = list(self._plain_mrs)
            for ptr, nbytes in mrs:
                if lib.its_conn_register_mr(
                    new_handle, ctypes.c_void_p(ptr), nbytes
                ) < 0:
                    lib.its_conn_close(new_handle)
                    lib.its_conn_destroy(new_handle)
                    raise InfiniStoreException(
                        "reconnect: re-registering memory regions failed"
                    )
            # Swap: from here every new op uses the fresh connection.
            old = self._handle
            self._handle = new_handle
            # A tick group open on the old handle died with it (its close
            # failed the captured ops); don't leave the window marked open
            # or the new handle would never batch again.
            self._group_open = False
            self._dead_shm_ranges += [
                (b.ctypes.data, b.nbytes) for b in self._shm_bufs
            ] + list(self._segment_aliases)
            self._shm_bufs.clear()
            self._segment_aliases.clear()
            self._plain_mrs = mrs
            if old is not None:
                lib.its_conn_close(old)  # in-flight ops fail out
                leftovers += self._drain_ring_locked(old)
                self._dead_handles.append(old)
            self._mark_connected()
        self._dispatch_completions(leftovers)
        # Outside the lock: listeners touch OTHER connections' locks (e.g. a
        # StripedConnection invalidating sibling stripes' aliases of the shm
        # segments this reconnect just unmapped — without this, a stripe-0
        # self-heal via the auto_reconnect decorator would leave live sibling
        # registrations over unmapped memory).
        for listener in list(self._reconnect_listeners):
            listener()

    def _require(self):
        if self._handle is None:
            raise InfiniStoreException("not connected")

    def _in_dead_shm(self, ptr: int) -> bool:
        return any(base <= ptr < base + n for base, n in self._dead_shm_ranges)

    def _prune_dead_shm(self, ptr: int, nbytes: int):
        """A new mapping/registration can legitimately land at a recycled
        address — ranges it covers are no longer 'dead'."""
        self._dead_shm_ranges = [
            (b, n) for b, n in self._dead_shm_ranges
            if b + n <= ptr or ptr + nbytes <= b
        ]

    # -- memory registration ------------------------------------------------

    def register_mr(self, arg: Union[int, np.ndarray], size: Optional[int] = None):
        """Pin + register a local staging region for batched zero-copy I/O
        (reference register_mr, lib.py:581-616)."""
        ptr, nbytes = _extract_ptr_size(arg, size)
        with self._lock:  # a registration racing reconnect() must not be lost
            self._require()
            ret = lib.its_conn_register_mr(self._handle, ctypes.c_void_p(ptr), nbytes)
            if ret < 0:
                raise InfiniStoreException("register memory region failed")
            self._plain_mrs.append((ptr, nbytes))
            self._prune_dead_shm(ptr, nbytes)
            return ret

    def unregister_mr(self, arg: Union[int, np.ndarray]):
        """Drop a transfer-scoped registration (pair with register_mr for
        short-lived staging buffers; in-flight ops are unaffected)."""
        ptr, _ = _extract_ptr_size(arg, 0 if isinstance(arg, int) else None)
        with self._lock:
            self._require()
            return self._unregister_locked(ptr)

    def _unregister_locked(self, ptr: int):
        if lib.its_conn_unregister_mr(self._handle, ctypes.c_void_p(ptr)) != 0:
            # A silent miss would leak the region (and its mlock) forever.
            raise InfiniStoreException(
                f"unregister_mr: no region registered at base 0x{ptr:x}"
            )
        for i, (p, _) in enumerate(self._plain_mrs):
            if p == ptr:
                del self._plain_mrs[i]
                break
        self._segment_aliases = [(p, n) for p, n in self._segment_aliases if p != ptr]

    def _register_segment_alias(self, ptr: int, nbytes: int):
        """Register ANOTHER connection's shm segment as a plain region here
        (StripedConnection stripes share stripe 0's segment). Tracked
        separately from _plain_mrs: the memory dies with its owner, so
        reconnect() must NOT re-register it — the range goes dead instead,
        and retries with pointers into it get the typed shm error."""
        with self._lock:
            self._require()
            if lib.its_conn_register_mr(self._handle, ctypes.c_void_p(ptr), nbytes) < 0:
                raise InfiniStoreException("register memory region failed")
            self._segment_aliases.append((ptr, nbytes))
            self._prune_dead_shm(ptr, nbytes)

    def _invalidate_segment_aliases(self):
        """The owner of the aliased segment reconnected (its mapping is
        gone): drop this connection's alias registrations and mark the
        ranges dead so stale-pointer retries get the typed shm error."""
        with self._lock:
            for ptr, nbytes in self._segment_aliases:
                try:
                    if self._handle is not None:
                        self._unregister_locked(ptr)
                # Audited: teardown bookkeeping — the registration is
                # already gone natively; the dead range below still guards.
                except InfiniStoreException:  # its: allow[ITS-P001]
                    pass
                self._dead_shm_ranges.append((ptr, nbytes))
            self._segment_aliases = []

    def alloc_shm_mr(self, nbytes: int) -> Optional[np.ndarray]:
        """Allocate a staging buffer the server maps too (one-RTT data plane:
        the server pulls puts out of / pushes gets into it directly — the shm
        analogue of the reference's one-sided RDMA against registered client
        memory). Returns a uint8 array view; when the server is remote or
        shm-less the buffer is still a valid registered region, batched ops
        just ride the socket path instead. Returns None only when allocation
        itself fails. The segment lives until close()."""
        self._require()
        ptr = lib.its_conn_alloc_shm_mr(self._handle, nbytes)
        if not ptr:
            return None
        buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        arr = np.frombuffer(buf, dtype=np.uint8)
        self._prune_dead_shm(ptr, nbytes)
        # ndarrays forbid new attributes, so anchor the view on the connection
        # instead; the mapping lives until close() anyway.
        self._shm_bufs.append(arr)
        return arr

    # -- batched async data plane -------------------------------------------

    def _semaphore(self, loop) -> asyncio.BoundedSemaphore:
        # Lock-free fast path: dict reads are atomic under the GIL, and a
        # loop's entry never changes once inserted — only insertion (below)
        # and close() mutate the registry. Saves a threading-lock round trip
        # per async op on the latency path.
        sem = self._semaphores.get(loop)
        if sem is not None:
            return sem
        with self._lock:  # loops in different threads may race the registry
            sem = self._semaphores.get(loop)
            if sem is None:
                # Prune dead loops BEFORE inserting (the registry is tiny,
                # so the scan is cheaper than the leak it prevents).
                for dead in [lp for lp in self._semaphores if lp.is_closed()]:
                    del self._semaphores[dead]
                sem = asyncio.BoundedSemaphore(self.MAX_INFLIGHT)
                self._semaphores[loop] = sem
            return sem

    def _ensure_reader(self, loop):
        """Register the completion-eventfd with this loop's selector (once
        per loop). Must be called ON the loop."""
        if loop not in self._reader_loops:
            loop.add_reader(self._efd, self._drain_ready)
            self._reader_loops.add(loop)

    def _drain_ring_locked(self, handle) -> list:
        """Pop all ring completions from a handle (caller holds _lock).
        Returns (token, code) pairs for _dispatch_completions."""
        pairs = []
        if self._efd is None:
            return pairs
        while True:
            n = lib.its_conn_drain_completions(
                handle, self._drain_tokens, self._drain_codes, _DRAIN_CAP
            )
            pairs += [
                (self._drain_tokens[i], self._drain_codes[i]) for i in range(n)
            ]
            if n < _DRAIN_CAP:
                return pairs

    def _dispatch_completions(self, pairs):
        """Resolve drained (token, code) pairs. Futures owned by the loop we
        are currently running on complete inline; foreign loops get one
        call_soon_threadsafe each (rare: cross-loop/teardown cases only)."""
        if not pairs:
            return
        # Inter-completion gap EWMA (alpha = 1/8, the reactor's constant)
        # feeding _poll_budget_s. Loop-thread-only state; a rare foreign-loop
        # dispatch writing it too just perturbs the heuristic, not safety.
        now = time.monotonic()
        if self._comp_last_ts:
            gap = now - self._comp_last_ts
            self._comp_gap_ewma = (
                gap if self._comp_gap_ewma == 0.0
                else (self._comp_gap_ewma * 7.0 + gap) / 8.0
            )
        self._comp_last_ts = now
        try:
            current = asyncio.get_running_loop()
        except RuntimeError:
            current = None
        for token, code in pairs:
            entry = _completions.pop(token, None)
            if entry is None:
                continue
            loop, future, on_done = entry
            if loop is current:
                on_done(future, code)
            else:
                try:
                    loop.call_soon_threadsafe(on_done, future, code)
                except RuntimeError:
                    pass  # loop closed before its op completed

    def _drain_ready(self):
        """add_reader callback: clear the eventfd, then drain + dispatch.
        The native side pushes to the ring BEFORE signalling, and we clear
        BEFORE draining, so any push racing this drain re-arms the fd."""
        try:
            os.eventfd_read(self._efd)
        except (BlockingIOError, OSError):
            pass  # another loop's drain got here first, or fd is closing
        woke = False
        while True:
            with self._lock:  # two loops may share this efd; serialize
                if self._handle is None:
                    return
                n = lib.its_conn_drain_completions(
                    self._handle, self._drain_tokens, self._drain_codes, _DRAIN_CAP
                )
                pairs = [
                    (self._drain_tokens[i], self._drain_codes[i]) for i in range(n)
                ]
                if n:
                    if not woke:
                        woke = True
                        self._drain_wakeups += 1
                    self._drain_completed += n
            self._dispatch_completions(pairs)
            if n < _DRAIN_CAP:
                return

    def _group_join(self, loop):
        """Join this event-loop iteration's ring post group, opening it on
        the first call of the tick. The native side captures every
        callback-free ring post made by this thread until _group_flush runs
        — scheduled via call_soon, which asyncio's _run_once snapshot
        semantics guarantee executes only after every callback already
        ready this iteration (i.e. after every same-tick submit), so a
        coalesced flush's K ops publish as one multi-op batch slot."""
        if self._group_open or self._handle is None:
            return
        self._group_open = True
        lib.its_conn_ring_group_begin(self._handle)
        loop.call_soon(self._group_flush)

    def _group_flush(self):
        """End of the tick's batch window: publish the captured posts as
        batch slot(s) + at most one doorbell. Safe if the connection died
        mid-tick — the native close already failed the captured ops."""
        self._group_open = False
        if self._handle is not None:
            lib.its_conn_ring_group_end(self._handle)

    def ring_batch_window(self):
        """Eagerly open this event-loop tick's ring batch window (no-op
        without a running loop or the ring plane). Submit-side coalescers
        (connector.FetchCoalescer) call this before fanning a flush out
        into per-op tasks: the window is then already open when those tasks
        submit — even grandchild tasks a StripedConnection spawns — so the
        whole flush rides one batch slot (docs/descriptor_ring.md)."""
        if self._efd is None or self._handle is None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._batch_windows += 1
        self._group_join(loop)

    async def _ring_await(self, future):
        """Adaptive poll-then-park for a ring-mode completion: spin draining
        the native completion ring for a budget calibrated from the
        inter-completion gap EWMA (min(2 x EWMA, 200us) — 0 when gaps are
        long, so slow traffic parks immediately), yielding the GIL and the
        core each iteration; only when the budget expires fall back to the
        eventfd -> add_reader wakeup chain and its scheduler latency."""
        budget = _poll_budget_s(self._comp_gap_ewma)
        if budget > 0.0 and not future.done():
            deadline = time.monotonic() + budget
            while True:
                with self._lock:
                    if self._handle is None:
                        break
                    n = lib.its_conn_drain_completions(
                        self._handle, self._drain_tokens, self._drain_codes,
                        _DRAIN_CAP,
                    )
                    pairs = [
                        (self._drain_tokens[i], self._drain_codes[i])
                        for i in range(n)
                    ]
                if n:
                    self._bridge_poll_drained += n
                    self._dispatch_completions(pairs)
                if future.done():
                    self._bridge_poll_hits += 1
                    return await future
                if time.monotonic() >= deadline:
                    break
                # Let same-tick siblings run (their flush may not have
                # happened yet) and give the core to the native threads
                # actually moving bytes — mandatory on shared cores.
                await asyncio.sleep(0)
                os.sched_yield()
        self._bridge_poll_arms += 1
        return await future

    def _bg_subbatches(self, blocks, block_size: int):
        """Split a BACKGROUND batch into bounded sub-batches: half the
        in-flight byte budget (BG_SUBBATCH_BYTES) each, pipelined two at a
        time by _batch_op — in-flight background bytes never exceed the
        budget (no foreground op queues behind one multi-MB burst), while
        the pipeline hides the per-sub-batch round trip that strict
        serialization would pay (~20-30% of background throughput,
        measured). Returns [blocks] unchanged for batches under half the
        budget."""
        per = max(1, self.BG_SUBBATCH_BYTES // 2 // max(1, block_size))
        if len(blocks) <= per:
            return [blocks]
        return [blocks[s : s + per] for s in range(0, len(blocks), per)]

    async def _batch_op(
        self, native_fn, blocks, block_size: int, ptr: int, op_name: str,
        priority: int = wire.PRIORITY_FOREGROUND,
    ):
        self._qos_ops[1 if priority else 0] += 1
        if priority:
            # Background: bounded sub-batches, at most two in flight (their
            # combined bytes <= BG_SUBBATCH_BYTES), each deferring at the
            # process-wide foreground gate before submission. The two-deep
            # window keeps the pipe full across sub-batch boundaries; the
            # byte bound keeps foreground ops from queueing behind a burst.
            rc = wire.STATUS_OK
            futs: list = []
            try:
                for chunk in self._bg_subbatches(blocks, block_size):
                    # Traced, the sub-batch's span opens before the deferral,
                    # so start -> submit holds the whole client-side queue.
                    span = _store_span(op_name)
                    await _bg_gate_wait(self)
                    if span is not None:
                        span.annotate(bg_gate_us=tracing.now_us() - span.t0_us)
                    futs.append(asyncio.ensure_future(self._batch_op_once(
                        native_fn, chunk, block_size, ptr, op_name, priority,
                        span=span,
                    )))
                    if len(futs) >= 2:
                        rc = await futs.pop(0)
                while futs:
                    rc = await futs.pop(0)
                return rc
            finally:
                # An early failure must still settle submitted siblings
                # before the caller may free the staging buffer.
                if futs:
                    await asyncio.gather(*futs, return_exceptions=True)
        _fg_gate_enter()
        try:
            return await self._batch_op_once(
                native_fn, blocks, block_size, ptr, op_name, priority
            )
        finally:
            _fg_gate_exit()

    def _marshal_batch(self, blocks):
        """(keys, keys_blob, offsets_array) for a batched op, memoized on
        the layout value (see _marshal_cache). The native submit copies
        both buffers into its own request/slot storage before returning —
        the pre-cache code already freed them while ops were in flight —
        so sharing one immutable entry across submits is safe."""
        keys, offsets = zip(*blocks)
        ent = self._marshal_cache.get((keys, offsets))
        if ent is None:
            if len(self._marshal_cache) >= _MARSHAL_CACHE_CAP:
                try:
                    self._marshal_cache.pop(
                        next(iter(self._marshal_cache)), None)
                except (StopIteration, RuntimeError):
                    pass  # concurrent sync-op thread beat us to the evict
            ent = (
                wire.encode_keys_blob(keys),
                (ctypes.c_uint64 * len(offsets))(*offsets),
            )
            self._marshal_cache[(keys, offsets)] = ent
        return keys, ent[0], ent[1]

    async def _batch_op_once(
        self, native_fn, blocks, block_size: int, ptr: int, op_name: str, priority: int,
        span=None,
    ):
        # Trace context (docs/observability.md): the op's own ``store.<op>``
        # span — a child of the span bound by the engine/connector layer
        # above — opens here, where the op asks for the in-flight
        # semaphore (or, for a BACKGROUND sub-batch, before its deferral:
        # ``span``), stamps `submit` once and `completion_ring` once; its
        # (trace id, span id) ride the wire so the server's tick ring
        # records this op. Tracing off: one module-bool check, wire bytes
        # untouched.
        self._require()
        keys, keys_blob, offs = self._marshal_batch(blocks)
        n = len(keys)
        if span is None:
            span = _store_span(op_name)

        loop = asyncio.get_running_loop()
        sem = self._semaphore(loop)
        try:
            await sem.acquire()
        except BaseException as e:
            if span is not None:
                span.finish(status=f"error:{type(e).__name__}")
            raise
        future = loop.create_future()
        token = next(_completion_token)

        trace_id, span_id = tracing.wire_ids(span)
        if span is not None:
            span.stage("submit")
            span.annotate(op=op_name, blocks=n, block_size=block_size,
                          priority=priority)

        def on_done(fut, code):
            sem.release()
            if span is not None:
                span.stage("completion_ring")
                span.finish("ok" if code == wire.STATUS_OK else f"error:status={code}")
            if fut.cancelled():
                return
            if code == wire.STATUS_OK:
                fut.set_result(code)
            elif code == wire.STATUS_KEY_NOT_FOUND:
                fut.set_exception(InfiniStoreKeyNotFound(f"{op_name}: key not found"))
            elif code == wire.STATUS_COLD_TIER:
                fut.set_exception(InfiniStoreColdTier(
                    f"{op_name}: key(s) cold but alive (spilled beyond the "
                    "promotion budget — retry smaller/later)"
                ))
            elif code == wire.STATUS_OOM:
                fut.set_exception(InfiniStoreResourcePressure(
                    f"{op_name}: store out of memory (data may survive spilled)"
                ))
            else:
                fut.set_exception(InfiniStoreException(f"{op_name} failed: status={code}"))

        use_ring = self._efd is not None
        if use_ring:
            self._ensure_reader(loop)
            # Join the tick's batch window: every ring post until the
            # call_soon'd flush publishes in one multi-op batch slot.
            self._group_join(loop)
        _completions[token] = (loop, future, on_done)
        rc = native_fn(
            self._handle,
            keys_blob,
            len(keys_blob),
            n,
            offs,
            block_size,
            ctypes.c_void_p(ptr),
            _NULL_CB if use_ring else _on_complete,
            ctypes.c_void_p(token),
            priority,
            trace_id,
            span_id,
        )
        if rc != 0:
            _completions.pop(token, None)
            sem.release()
            if span is not None:
                span.finish(status="error:submit")
            raise InfiniStoreException(
                f"{op_name}: submit failed (not connected, or base pointer "
                "not inside a registered region — call register_mr first)"
            )
        if use_ring:
            return await self._ring_await(future)
        return await future

    async def rdma_write_cache_async(
        self, blocks: List[Tuple[str, int]], block_size: int, ptr: int,
        priority: int = PRIORITY_FOREGROUND,
    ):
        """Async batched block write: for each (key, offset) send block_size
        bytes from ptr+offset (reference lib.py:425). On TPU the transport is
        the zero-copy DCN socket plane, not ibverbs; the name is kept for
        drop-in compatibility, write_cache_async is the native alias.

        ``priority``: QoS class (wire.PRIORITY_FOREGROUND default /
        wire.PRIORITY_BACKGROUND). A BACKGROUND op is tagged on the wire
        (the server's two-level slice scheduler defers its work behind
        foreground ops, with a starvation-proof aging escape) and submitted
        in bounded sub-batches (BG_SUBBATCH_BYTES); FOREGROUND stays
        byte-identical to the untagged pre-QoS op. Atomicity caveat: each
        sub-batch is its own wire op, so a BACKGROUND batch larger than
        half the budget is NOT all-or-nothing — a mid-batch failure leaves
        earlier sub-batches applied (written keys persisted; on reads,
        earlier blocks already scattered into ``ptr``). That is the
        intended contract for the class (bulk, idempotent producers:
        saves rewrite the same bytes, prefetch staging is discarded whole
        on failure); traffic that needs the untagged path's atomicity
        should stay FOREGROUND. See docs/qos.md.

        Ordering: batched ops order only via their completion awaitables. On
        the shm fast path a put publishes its keys in a later commit leg, so
        a get submitted before the put's future resolves may see KeyNotFound
        even on the same connection — await the put first (the socket path
        happens to serialize, but that is not part of the contract)."""
        return await self._batch_op(
            lib.its_conn_put_batch, blocks, block_size, ptr, "write_cache",
            priority,
        )

    async def rdma_read_cache_async(
        self, blocks: List[Tuple[str, int]], block_size: int, ptr: int,
        priority: int = PRIORITY_FOREGROUND,
    ):
        """Async batched block read into ptr+offset per key (reference
        lib.py:483). Raises InfiniStoreKeyNotFound when any key is missing.
        ``priority``: see write_cache_async."""
        return await self._batch_op(
            lib.its_conn_get_batch, blocks, block_size, ptr, "read_cache",
            priority,
        )

    # TPU-native aliases.
    write_cache_async = rdma_write_cache_async
    read_cache_async = rdma_read_cache_async

    # -- sync batched data plane (low-latency path) ---------------------------

    def _batch_op_sync(
        self, native_fn, blocks, block_size: int, ptr: int, op_name: str,
        priority: int = wire.PRIORITY_FOREGROUND,
    ):
        self._qos_ops[1 if priority else 0] += 1
        if priority:
            rc = 0
            for chunk in self._bg_subbatches(blocks, block_size):
                _bg_gate_wait_sync(self)
                rc = self._batch_op_sync_once(
                    native_fn, chunk, block_size, ptr, op_name, priority
                )
            return rc
        _fg_gate_enter()
        try:
            return self._batch_op_sync_once(
                native_fn, blocks, block_size, ptr, op_name, priority
            )
        finally:
            _fg_gate_exit()

    def _batch_op_sync_once(
        self, native_fn, blocks, block_size: int, ptr: int, op_name: str, priority: int
    ):
        self._require()
        keys, keys_blob, offs = self._marshal_batch(blocks)
        n = len(keys)
        # Sync path trace stamps, on the op's own store.<op> span: submit
        # before the blocking native call, completion_ring right after it
        # returns (the calling thread IS the completion wait — there is no
        # ring drain to stamp separately).
        span = _store_span(op_name)
        trace_id, span_id = tracing.wire_ids(span)
        if span is not None:
            span.stage("submit")
            span.annotate(op=op_name, blocks=n, block_size=block_size,
                          priority=priority)
        rc = native_fn(
            self._handle, keys_blob, len(keys_blob), n, offs, block_size,
            ctypes.c_void_p(ptr), priority, trace_id, span_id,
        )
        if span is not None:
            span.stage("completion_ring")
            span.finish("ok" if rc == 0 else f"error:status={-rc}")
        if rc == 0:
            return wire.STATUS_OK
        if rc == -wire.STATUS_KEY_NOT_FOUND:
            raise InfiniStoreKeyNotFound(f"{op_name}: key not found")
        if rc == -wire.STATUS_COLD_TIER:
            raise InfiniStoreColdTier(
                f"{op_name}: key(s) cold but alive (spilled beyond the "
                "promotion budget — retry smaller/later)"
            )
        if rc == -wire.STATUS_OOM:
            raise InfiniStoreResourcePressure(
                f"{op_name}: store out of memory (data may survive spilled)"
            )
        raise InfiniStoreException(f"{op_name} failed: status={-rc}")

    @_reconnecting(ptr_arg=2)
    def write_cache(
        self, blocks: List[Tuple[str, int]], block_size: int, ptr: int,
        priority: int = PRIORITY_FOREGROUND,
    ):
        """Blocking batched block write; the calling thread waits on the
        native completion directly (no event-loop hop). ~3x lower p50 than
        the async path for single-block ops on a same-host store — use it on
        latency-critical paths; the async API remains the throughput path
        (pipelining many ops). The ctypes call releases the GIL.

        Timeout (``op_timeout_ms``, default 30s): raises status 503 and
        abandons the wait. For plain registered buffers the native layer
        guarantees the abandoned op never touches the buffer again — an
        unsent request is dropped, a late response is drained into scratch
        (never scattered into ``ptr``), and a request half-streamed from the
        buffer fails the connection rather than read it — so the buffer may
        be freed after the exception (unregister_mr first if it was
        explicitly registered). For ``alloc_shm_mr`` SEGMENT buffers that
        guarantee is impossible (the server moves the bytes in the shared
        mapping), so a timed-out segment op FAILS THE CONNECTION
        deterministically; reallocate segment views after reconnecting.

        ``priority``: QoS class tag (see write_cache_async)."""
        return self._batch_op_sync(
            lib.its_conn_put_batch_sync, blocks, block_size, ptr, "write_cache",
            priority,
        )

    @_reconnecting(ptr_arg=2)
    def read_cache(
        self, blocks: List[Tuple[str, int]], block_size: int, ptr: int,
        priority: int = PRIORITY_FOREGROUND,
    ):
        """Blocking batched block read (see write_cache for latency/timeout
        semantics — on timeout the late payload is drained, never written
        into ``ptr``). Raises InfiniStoreKeyNotFound when any key is
        missing. ``priority``: QoS class tag (see write_cache_async —
        including the BACKGROUND sub-batch atomicity caveat: a failing
        tagged read larger than half the budget may have scattered its
        earlier sub-batches into ``ptr``)."""
        return self._batch_op_sync(
            lib.its_conn_get_batch_sync, blocks, block_size, ptr, "read_cache",
            priority,
        )

    # -- single-key TCP path -------------------------------------------------

    @_reconnecting(ptr_arg=1)
    def tcp_write_cache(self, key: str, ptr: int, size: int, **kwargs):
        """Blocking single-key put from a raw pointer (reference lib.py:399)."""
        self._require()
        rc = lib.its_conn_tcp_put(self._handle, key.encode(), ctypes.c_void_p(ptr), size)
        if rc == -wire.STATUS_OOM:
            # Same split as the batched paths: pressure (retry/recompute;
            # data may survive spilled) is not a transport failure.
            raise InfiniStoreResourcePressure(
                "tcp_write_cache: store out of memory"
            )
        if rc != 0:
            raise InfiniStoreException(f"tcp_write_cache failed: status={-rc}")
        return wire.STATUS_OK

    @_reconnecting()
    def tcp_read_cache(self, key: str, **kwargs) -> np.ndarray:
        """Blocking single-key get; zero-copy numpy view over the native
        buffer (the reference zero-copies via a pybind capsule,
        pybind.cpp:23-34; here the finalizer frees the malloc'd buffer)."""
        self._require()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_size = ctypes.c_uint64()
        rc = lib.its_conn_tcp_get(
            self._handle, key.encode(), ctypes.byref(out), ctypes.byref(out_size)
        )
        if rc == -wire.STATUS_KEY_NOT_FOUND:
            raise InfiniStoreKeyNotFound(f"key not found: {key}")
        if rc == -wire.STATUS_COLD_TIER:
            # Present-but-unpromotable spilled key (server.cpp single-key
            # GET, the typed 512): the data is COLD BUT ALIVE — tier-aware
            # callers count a demotion hit, not a miss (docs/tiering.md).
            raise InfiniStoreColdTier(
                f"tcp_read_cache: {key!r} is cold but alive (spilled; RAM "
                "too pressured to promote now)"
            )
        if rc == -wire.STATUS_OOM:
            raise InfiniStoreResourcePressure(
                f"tcp_read_cache: store too pressured to serve {key!r} now"
            )
        if rc != 0:
            raise InfiniStoreException(f"tcp_read_cache failed: status={-rc}")
        n = out_size.value
        arr = np.ctypeslib.as_array(out, shape=(n,))
        # Free the native buffer when the array (base) is collected.
        ptr_val = ctypes.cast(out, ctypes.c_void_p).value
        weakref.finalize(arr, lib.its_free, ptr_val)
        return arr

    # -- control ops ---------------------------------------------------------

    @_reconnecting()
    def check_exist(self, key: str) -> bool:
        """True if the key is committed on the server (reference lib.py:544)."""
        self._require()
        rc = lib.its_conn_check_exist(self._handle, key.encode())
        if rc < 0:
            raise InfiniStoreException(f"check_exist failed: status={-rc}")
        return rc == 1

    def _encode_match_keys(self, keys: List[str]) -> bytes:
        """Encode the key chain, reusing the previous call's encoding for the
        shared prefix. Chains are append-only (each key hashes the whole
        prefix), so admission-time lookups re-encode hundreds of unchanged
        keys per request; the list compares run at C speed and the encode —
        ~67us for 256 keys, 3x the transport cost of the lookup itself —
        happens only for the new tail."""
        cached, cached_blob = self._match_cache  # one read: threads race this
        if keys == cached:
            return cached_blob
        lc = len(cached)
        if lc and len(keys) > lc and keys[:lc] == cached:
            blob = cached_blob + wire.encode_keys_blob(keys[lc:])
        else:
            blob = wire.encode_keys_blob(keys)
        self._match_cache = (list(keys), blob)  # atomic swap (GIL)
        return blob

    @_reconnecting()
    def get_match_last_index(self, keys: List[str]) -> int:
        """Longest-prefix match index over a key chain (reference lib.py:562;
        server does binary search under the prefix property, SURVEY.md §3.6)."""
        self._require()
        blob = self._encode_match_keys(keys)
        idx = lib.its_conn_match_last_index(self._handle, blob, len(blob), len(keys))
        if idx == -(2**31):
            raise InfiniStoreException("get_match_last_index transport error")
        if idx < 0:
            raise InfiniStoreNoMatch("can't find a match")
        return idx

    @_reconnecting()
    def delete_keys(self, keys: List[str]) -> int:
        """Delete keys; returns how many were present (reference lib.py:618)."""
        self._require()
        blob = wire.encode_keys_blob(keys)
        ret = lib.its_conn_delete_keys(self._handle, blob, len(blob), len(keys))
        if ret < 0:
            raise InfiniStoreException(
                "somethings are wrong, not all the specified keys were deleted"
            )
        return int(ret)

    def completion_stats(self) -> dict:
        """Async-bridge coalescing counters for this connection's lifetime:
        ``completions`` (ring pushes by the native reactor),
        ``wakeups_signalled`` (eventfd writes — one per empty->non-empty
        transition; completions landing while a wakeup is armed piggyback
        on it), and the loop-side ``loop_wakeups``/``loop_drained`` drain
        counts. ``completion_batch_size`` = completions / signals: 1.0
        means every op paid its own wakeup; higher means pipelined ops
        shared them (the bench's ``completion_batch_size`` key).

        The adaptive bridge poll adds ``bridge_poll_hits`` /
        ``bridge_poll_arms`` — ring-mode waits resolved inside the
        calibrated pre-park poll window vs parked on the eventfd — and
        ``bridge_poll_drained``, completions those poll windows drained
        (they skip the wakeup chain entirely; docs/descriptor_ring.md,
        poll-then-park section)."""
        pushed = ctypes.c_uint64()
        signalled = ctypes.c_uint64()
        with self._lock:
            if self._handle is not None:
                lib.its_conn_completion_counters(
                    self._handle, ctypes.byref(pushed), ctypes.byref(signalled)
                )
            wakeups, drained = self._drain_wakeups, self._drain_completed
        return {
            "completions": pushed.value,
            "wakeups_signalled": signalled.value,
            "loop_wakeups": wakeups,
            "loop_drained": drained,
            "completion_batch_size": (
                pushed.value / signalled.value if signalled.value else 0.0
            ),
            # Adaptive bridge poll (_ring_await): waits resolved inside the
            # poll window vs parked on the eventfd, and completions the poll
            # drains dispatched (those never pay the wakeup chain at all).
            "bridge_poll_hits": self._bridge_poll_hits,
            "bridge_poll_arms": self._bridge_poll_arms,
            "bridge_poll_drained": self._bridge_poll_drained,
        }

    def ring_stats(self) -> dict:
        """Client half of the descriptor-ring ledger
        (docs/descriptor_ring.md; the server half is
        ``get_stats()["ring"]``): ``ring_posted`` descriptors published to
        the submission ring, ``ring_doorbells`` doorbell frames actually
        sent (empty->non-empty doze transitions only — the
        ``ring_doorbell_ratio`` = posted / doorbells is the submit-side
        coalescing the bench watches), ``ring_full_fallbacks`` /
        ``ring_meta_fallbacks`` ops that rode the socket path instead
        (ring-full backpressure / descriptor body over the slot stride —
        counted, never an error), and ``ring_completions`` consumed from
        the completion ring.

        Mechanism counters ride along: ``ring_batch_slots`` multi-op
        batch slots published / ``ring_batch_ops`` ops they carried
        (``ring_batch_ops_per_slot`` = ops / slots, the flush-coalescing
        ratio — ops in plain slots count in neither), ``ring_poll_hits`` /
        ``ring_poll_arms`` reactor pre-park CQ poll windows that caught a
        completion vs expired into the epoll park, and
        ``ring_batch_windows`` eager ring_batch_window() opens."""
        posted = ctypes.c_uint64()
        doorbells = ctypes.c_uint64()
        full = ctypes.c_uint64()
        meta = ctypes.c_uint64()
        completions = ctypes.c_uint64()
        batch_slots = ctypes.c_uint64()
        batch_ops = ctypes.c_uint64()
        poll_hits = ctypes.c_uint64()
        poll_arms = ctypes.c_uint64()
        with self._lock:
            if self._handle is not None:
                lib.its_conn_ring_counters(
                    self._handle, ctypes.byref(posted), ctypes.byref(doorbells),
                    ctypes.byref(full), ctypes.byref(meta),
                    ctypes.byref(completions),
                )
                lib.its_conn_ring_poll_counters(
                    self._handle, ctypes.byref(batch_slots),
                    ctypes.byref(batch_ops), ctypes.byref(poll_hits),
                    ctypes.byref(poll_arms),
                )
        return {
            "ring_posted": posted.value,
            "ring_doorbells": doorbells.value,
            "ring_full_fallbacks": full.value,
            "ring_meta_fallbacks": meta.value,
            "ring_completions": completions.value,
            "ring_doorbell_ratio": (
                posted.value / doorbells.value if doorbells.value else 0.0
            ),
            "ring_batch_slots": batch_slots.value,
            "ring_batch_ops": batch_ops.value,
            "ring_batch_ops_per_slot": (
                batch_ops.value / batch_slots.value if batch_slots.value else 0.0
            ),
            "ring_poll_hits": poll_hits.value,
            "ring_poll_arms": poll_arms.value,
            "ring_batch_windows": self._batch_windows,
        }

    def qos_stats(self) -> dict:
        """Client-side per-class batched-op counters (the QoS ledger's
        client half; the server's scheduler counters are
        ``get_stats()["qos"]``): ``fg_ops``/``bg_ops`` per-class op
        counts, ``bg_deferred``/``bg_aged`` — this connection's background
        sub-batches held at / aged past the process-wide foreground gate —
        and ``fg_inflight``, the live process-wide foreground count the
        gate blocks on."""
        return {
            "fg_ops": self._qos_ops[0],
            "bg_ops": self._qos_ops[1],
            "bg_deferred": self._bg_deferred,
            "bg_aged": self._bg_aged,
            "fg_inflight": _fg_inflight,
        }

    @_reconnecting()
    def get_stats(self) -> dict:
        """Server-side per-op latency/throughput counters — first-class
        observability the reference lacks (SURVEY.md §5.1).

        Snapshot keys (the manage plane serves the same dict at ``/stats``
        and summarizes it at ``/metrics``; tools/analysis ``counters``
        keeps all three surfaces in sync):

        - ``kvmap_len``, ``usage``, ``total_bytes``, ``used_bytes``,
          ``pools``, ``pinned`` — store occupancy and pool directory size;
        - ``connections``, ``conns_accepted`` — live vs lifetime-accepted
          data-plane connections;
        - ``spill``: ``entries``, ``bytes``, ``capacity``, ``promotions``,
          ``dropped`` — the disk spill tier;
        - ``qos``: ``fg_ops``/``bg_ops``, ``fg_slices``/``bg_slices``,
          ``bg_preempted_slices``, ``bg_aged_slices``, ``fg_queued``/
          ``bg_queued``, plus the ``bg_cooldown_us``/``bg_aging_us``
          tunables — the two-class slice scheduler (docs/qos.md);
        - ``suspended_ops`` — sliced ops parked in the reactor;
        - ``ring``: the descriptor-ring data plane
          (docs/descriptor_ring.md) — ``attached`` lifetime successful
          attaches, ``conns`` live attached connections, ``descriptors``
          consumed from submission rings, ``doorbells_rx`` /
          ``cq_doorbells_tx`` doorbell frames each direction (vs
          ``descriptors``: the doze/wake coalescing ratio),
          ``completions`` CQEs published, ``bad_descriptors`` rejected
          per-descriptor (400 CQE), ``torn_descriptors`` generation-tag
          mismatches (fatal), the live ``sq_depth`` /``pending`` queue
          depths, ``batch_slots``/``batch_ops`` multi-op batch slots
          consumed and the ops they carried, ``poll_hits``/``poll_arms``
          adaptive pre-park SQ poll windows that caught work vs expired
          into the epoll doze, and ``doorbell_elided`` completion
          doorbells skipped because the client reactor was already awake
          polling its CQ;
        - ``trace``: the server-side trace tick ring
          (docs/observability.md) — ``recorded``/``dropped`` ring
          counters and ``entries``, each ``{trace_id, parent_id, op,
          prio, ok, recv_us, first_slice_us, last_slice_us, done_us,
          bytes}`` — the ticks ``GET /trace`` joins to client spans;
        - ``prof``: reactor loop-pass phase accounting
          (docs/observability.md, profiling section) — ``passes`` plus
          cumulative per-phase microseconds: ``wait_us`` (blocked in
          epoll), ``events_us`` (socket event dispatch), ``rings_us``
          (descriptor-ring drain), ``slices_us`` (cont slices + their
          QoS scheduling decisions), ``poll_us`` (the adaptive pre-park
          SQ busy-poll window), ``other_us`` (park/doorbell arming
          and bookkeeping) — exported as ``infinistore_prof_*``;
        - ``ops``: per-opcode ``count``, ``errors``, ``bytes_in``,
          ``bytes_out``, ``total_us``, ``p50_us``, ``p99_us``, and
          ``hist_us`` — sparse ``[le_us, count]`` latency buckets
          (base-2 octaves, 32 sub-buckets, ~2% resolution; the
          ``infinistore_op_duration_us`` histogram /metrics renders,
          and what the p50/p99 gauges are derived from)."""
        self._require()
        buf = ctypes.create_string_buffer(256 << 10)
        n = lib.its_conn_stat_json(self._handle, buf, len(buf))
        if n < 0:
            raise InfiniStoreException("stat query failed")
        try:
            return json.loads(buf.value.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            # A dead/half-closed server can answer with an empty or truncated
            # payload; that is a transport failure, not a caller bug — keep
            # the typed-exception contract every other op has.
            raise InfiniStoreException(f"stat query returned invalid payload: {e}")


class StripedConnection:
    """N socket streams to one server behind the single-connection API.

    The reference reaches cross-host line rate by keeping up to 8000
    outstanding work requests on ONE RDMA queue pair (reference
    src/protocol.h:22-26); a TCP stream has no such depth — per-connection
    congestion windows and the kernel's per-socket processing cap a single
    stream well below NIC rate on DCN. Striping opens `streams` independent
    connections and fans batched ops out across them.

    The fan-out is an ADAPTIVE WORK-STEALING SCHEDULER, not a static split:
    each batched op is broken into bounded contiguous chunk descriptors
    (``wire.chunk_spans``) on a shared queue, and every stripe runs a worker
    that pulls the next span whenever it finishes its previous one — a slow
    stripe simply pulls less, so it can never gate the whole batch the way a
    static 1/N split lets it (the head-of-line failure BENCH_r05 measured as
    a 1.6x striped-vs-single inversion). How much a stripe pulls per trip
    adapts to its measured throughput EWMA (targeting ``TARGET_CHUNK_S`` of
    transfer per pull, so fast stripes amortize per-op cost over big spans
    while paced/slow ones stay at fine grain and rebalance quickly), capped
    by an even share of what remains so the batch TAIL is always split fine.
    Spans stay contiguous, so each stripe's scatter/gather iovec runs stay
    long. A same-host detector (the shm fast path active on stripe 0 — proof
    the data plane is a memcpy, where extra socket stripes only add reactor
    contention) collapses batched ops to stripe 0 automatically: striping
    can no longer lose to a single stream. See docs/multistream.md.

    Control ops, the shm fast path, and stats ride stripe 0; batched
    data-plane ops fan out. The surface mirrors InfinityConnection.
    """

    # Descriptor granularity on the shared queue: the indivisible steal unit.
    CHUNK_QUANTUM_BLOCKS = 8
    # QoS (docs/qos.md): batched ops carry a two-class tag. The shared chunk
    # queue is priority-ordered operationally — while any FOREGROUND batched
    # op is pending on this connection, BACKGROUND workers defer their next
    # pull (up to BG_AGING_S, the starvation-proof aging escape), and a
    # BACKGROUND pull is capped at BG_MAX_PULL_BLOCKS so a foreground chunk
    # never waits behind one huge background span on a stripe.
    QOS_AWARE = True
    BG_MAX_PULL_BLOCKS = 8
    BG_AGING_S = 0.05  # max time one bg pull defers to fg before proceeding
    BG_POLL_S = 0.002  # deferral poll granularity (loop-agnostic, no Event)
    # Per-pull transfer-time target: big enough to amortize one batched op's
    # fixed cost (~tens of us), small enough that stripes rebalance within a
    # few ms when one slows down (and that a paced 50 MB/s stripe still makes
    # multiple trips per batch instead of swallowing a static share).
    TARGET_CHUNK_S = 0.004
    # Hard per-pull cap in blocks: bounds the damage of a stale (optimistic)
    # EWMA — at most this much work can strand behind a stripe that stalls
    # right after pulling.
    MAX_CHUNK_BLOCKS = 256
    EWMA_ALPHA = 0.3  # per-chunk throughput smoothing

    def __init__(
        self,
        config: ClientConfig,
        streams: int = 4,
        adaptive: bool = True,
        conn_factory=None,
    ):
        """``conn_factory(config, stripe_index) -> InfinityConnection-shaped``
        builds each stripe's connection (default: a plain
        ``InfinityConnection``) — the seam chaos tests use to wrap individual
        stripes in ``faults.FaultyConnection``."""
        if streams < 1:
            raise ValueError("streams must be >= 1")
        self.config = config
        self.adaptive = adaptive
        if conn_factory is None:
            conn_factory = lambda cfg, i: InfinityConnection(cfg)
        self.conns = [conn_factory(config, i) for i in range(streams)]
        # Per-stripe measured throughput EWMA in bytes/s (0 = unmeasured).
        # Persists across batches: the second batch starts from the first
        # batch's measured rates instead of re-probing.
        self._ewma_bps = [0.0] * streams
        self._sched_stats = {
            "batched_ops": 0,
            "collapsed_ops": 0,  # same-host detector sent the op to stripe 0
            "small_ops": 0,  # below 2*streams blocks: not worth splitting
            "chunks": 0,
            "steals": 0,  # pulls beyond each worker's first (stolen share)
            "stripe_chunks": [0] * streams,
            "stripe_blocks": [0] * streams,
            # Failure-domain counters (docs/robustness.md): per-stripe
            # transport errors, spans handed back to the shared queue by a
            # dying stripe, quarantine entries/exits, and sibling errors a
            # raised batch suppressed (visible here instead of only in a
            # log line).
            "stripe_errors": [0] * streams,
            "requeued_blocks": 0,
            "quarantines": 0,
            "rejoins": 0,
            "suppressed_errors": 0,
            # QoS ledger (docs/qos.md): per-class batched ops, background
            # pulls deferred behind pending foreground work, deferrals that
            # hit the aging cap and proceeded anyway, and background
            # sub-batches issued on the collapsed/small-op paths.
            "fg_ops": 0,
            "bg_ops": 0,
            "bg_deferred_pulls": 0,
            "bg_aged_pulls": 0,
            "bg_subbatches": 0,
        }
        # Count of FOREGROUND batched ops currently in flight on this
        # connection: the signal BACKGROUND workers defer on.
        self._fg_pending = 0
        # Stripe quarantine: a stripe whose batched op dies with a TRANSPORT
        # error hands its claimed span back to the shared queue, stops
        # pulling, and reconnects in the background while the survivors
        # drain the batch — one dead stream degrades throughput, never the
        # op. _revive_tasks maps stripe index -> live reconnect task.
        self._quarantined = [False] * streams
        self._revive_tasks: dict = {}
        self._striped_closed = False
        # Stripe 0 owns the shm segments the other stripes alias. WHENEVER it
        # reconnects — including a self-heal inside the auto_reconnect
        # decorator that this object never sees — the segments are unmapped
        # and sibling aliases must die with them, or a retried batched op
        # scatter/gathers into unmapped memory (crash) instead of raising the
        # typed dead-shm error.
        self.conns[0]._reconnect_listeners.append(self._on_owner_reconnect)

    def _on_owner_reconnect(self):
        for c in self.conns[1:]:
            c._invalidate_segment_aliases()

    # -- lifecycle -----------------------------------------------------------

    def connect(self):
        """Open every stripe's connection (blocking)."""
        for c in self.conns:
            c.connect()

    async def connect_async(self):
        """Open every stripe's connection concurrently."""
        await asyncio.gather(*(c.connect_async() for c in self.conns))

    def close(self):
        """Close every stripe (unmaps stripe 0's shm segments) and stop any
        background quarantine-reconnect tasks."""
        self._striped_closed = True
        for t in list(self._revive_tasks.values()):
            t.cancel()
        self._revive_tasks.clear()
        for c in self.conns:
            c.close()

    @property
    def is_connected(self) -> bool:
        """True only when EVERY stripe's reactor is live — full capacity.
        Batched ops survive partial death (a dead stripe is quarantined and
        the survivors drain the batch), so False here means degraded, not
        necessarily down; ``data_plane_stats()["quarantined"]`` says which
        stripes are out."""
        return all(c.is_connected for c in self.conns)

    def reconnect(self):
        """Reconnect every stripe (dead ones rebuilt, live ones kept),
        re-registering plain MRs per stripe. Same caveats as
        InfinityConnection.reconnect: alloc_shm_mr views do not survive, and
        a restarted store is a cold cache. With auto_reconnect configured,
        sync ops (stripe 0) self-heal; batched async callers invoke this
        after a failure — without it a restart left stripes 1..N dead.

        Sibling alias invalidation is NOT handled here: stripe 0's own
        reconnect() notifies _on_owner_reconnect every time it runs, whether
        invoked from this loop or from a sync-op self-heal."""
        for c in self.conns:
            if not c.is_connected:
                c.reconnect()

    @property
    def shm_active(self) -> bool:
        return self.conns[0].shm_active

    @property
    def ring_active(self) -> bool:
        """True when stripe 0 posts batched ops over the descriptor ring
        (same-host collapse routes batched ops there anyway)."""
        return self.conns[0].ring_active

    def ring_stats(self) -> dict:
        """Aggregate descriptor-ring ledger across stripes (see
        InfinityConnection.ring_stats)."""
        out = {
            "ring_posted": 0,
            "ring_doorbells": 0,
            "ring_full_fallbacks": 0,
            "ring_meta_fallbacks": 0,
            "ring_completions": 0,
            "ring_batch_slots": 0,
            "ring_batch_ops": 0,
            "ring_poll_hits": 0,
            "ring_poll_arms": 0,
            "ring_batch_windows": 0,
        }
        for c in self.conns:
            st = c.ring_stats()
            for k in out:
                out[k] += st[k]
        out["ring_doorbell_ratio"] = (
            out["ring_posted"] / out["ring_doorbells"]
            if out["ring_doorbells"]
            else 0.0
        )
        out["ring_batch_ops_per_slot"] = (
            out["ring_batch_ops"] / out["ring_batch_slots"]
            if out["ring_batch_slots"]
            else 0.0
        )
        return out

    def ring_batch_window(self):
        """Open every stripe's current-tick ring batch window (see
        InfinityConnection.ring_batch_window). Same-host collapse routes
        batched ops to stripe 0, but a flush's ops may fan out — open all."""
        for c in self.conns:
            c.ring_batch_window()

    # -- memory registration (fan out: a batch may land on any stripe) -------

    def register_mr(self, arg, size: Optional[int] = None):
        """Register the region on EVERY stripe (a batch chunk may land on
        any of them). Same argument forms as InfinityConnection.register_mr."""
        for c in self.conns:
            c.register_mr(arg, size)
        return 0

    def unregister_mr(self, arg):
        """Drop the region's registration from every stripe."""
        for c in self.conns:
            c.unregister_mr(arg)

    def alloc_shm_mr(self, nbytes: int) -> Optional[np.ndarray]:
        """Segment lives on stripe 0 (one-RTT path there); other stripes see
        it as a plain registered region (two-phase shm / socket path)."""
        buf = self.conns[0].alloc_shm_mr(nbytes)
        if buf is None:
            return None
        for c in self.conns[1:]:
            # Alias, not a plain MR: the segment belongs to stripe 0 and
            # must not be re-registered by these stripes on reconnect.
            c._register_segment_alias(buf.ctypes.data, nbytes)
        return buf

    # -- batched data plane: adaptive work-stealing fan-out ------------------

    def _split(self, blocks: List[Tuple[str, int]]) -> List[List[Tuple[str, int]]]:
        """Static contiguous 1/N split (the ``adaptive=False`` legacy path,
        kept for A/B comparison — benchmark.py ``--no-adaptive``)."""
        n = len(self.conns)
        per = (len(blocks) + n - 1) // n
        return [blocks[i : i + per] for i in range(0, len(blocks), per)]

    def memcpy_bound(self) -> bool:
        """Same-host detector: stripe 0's shm fast path being active proves
        client and server share a host and batched bytes move by memcpy
        (pool copy or one-RTT segment) — the regime where extra socket
        stripes only add reactor threads contending for the same cores.
        Deliberately NOT a throughput heuristic: a real DCN stripe can
        sustain GB/s too, and collapsing it would throw away the NIC
        headroom striping exists for; shm is unforgeable same-host proof
        and is off exactly when pacing emulates a cross-host link."""
        return self.conns[0].shm_active

    def _pull_blocks(
        self, idx: int, remaining: int, block_size: int,
        priority: int = PRIORITY_FOREGROUND,
    ) -> int:
        """How many blocks stripe ``idx`` takes this trip, in whole
        descriptor quanta: its throughput EWMA times the per-pull time
        target (unmeasured stripes start at one quantum so the first
        measurement lands fast), floored at one quantum, capped by
        MAX_CHUNK_BLOCKS and by an even share of what REMAINS — the tail of
        a batch is always split finely, so the last pulls cannot recreate
        the static split's one-slow-stripe long pole. BACKGROUND pulls are
        additionally capped at BG_MAX_PULL_BLOCKS (bounded in-flight work
        per stripe, so foreground chunks preempt between small pulls)."""
        q = self.CHUNK_QUANTUM_BLOCKS
        ewma = self._ewma_bps[idx]
        want = int(ewma * self.TARGET_CHUNK_S / block_size) if ewma > 0 else q
        fair = (remaining + len(self.conns) - 1) // len(self.conns)
        cap = self.BG_MAX_PULL_BLOCKS if priority else self.MAX_CHUNK_BLOCKS
        take = min(max(q, want), cap, max(q, fair), remaining)
        return max(1, (take // q) * q if take >= q else take)

    def _fg_busy(self) -> bool:
        # Foreground pressure: this connection's own pending fg batched ops
        # OR the process-wide gate (in flight anywhere, or within the
        # post-wave cooldown — the client-side tail lives in CPU/GIL
        # contention, which every connection in the process shares).
        return bool(self._fg_pending or _fg_gate_closed())

    async def _bg_throttle(self):
        """One BACKGROUND pull's deferral point: while FOREGROUND ops are
        pending (on this connection or process-wide), wait — bounded by
        BG_AGING_S, the aging escape that makes starvation impossible by
        construction — before taking more shared-queue work. The global
        signal waits on the process gate's condition variable (precise
        wake); only the narrow window where THIS connection's fg op is
        between chunk submissions (its native awaits register globally)
        falls back to the coarse BG_POLL_S sleep."""
        if not self._fg_busy() or self._striped_closed:
            return
        stats = self._sched_stats
        stats["bg_deferred_pulls"] += 1
        deadline = time.monotonic() + self.BG_AGING_S
        loop = asyncio.get_running_loop()
        while self._fg_busy() and not self._striped_closed:
            if time.monotonic() >= deadline:
                stats["bg_aged_pulls"] += 1
                return
            if _fg_gate_closed():
                if not await loop.run_in_executor(
                    _gate_executor(), _bg_gate_block, deadline
                ):
                    stats["bg_aged_pulls"] += 1
                    return
            else:
                await asyncio.sleep(self.BG_POLL_S)

    @staticmethod
    def _is_stripe_transport_error(e: BaseException) -> bool:
        """Quarantine only on TRANSPORT failures: a semantic error
        (KeyNotFound / pressure / no-match) means the server ANSWERED — the
        same answer awaits on every sibling stripe, so requeueing the span
        would just re-fail it; the batch aborts as one op instead."""
        return isinstance(e, InfiniStoreException) and not isinstance(
            e,
            (
                InfiniStoreKeyNotFound,
                InfiniStoreResourcePressure,
                InfiniStoreNoMatch,
            ),
        )

    def _quarantine(self, idx: int, exc: BaseException, op_name: str):
        """Remove stripe ``idx`` from the fan-out and start its background
        reconnect (one task per stripe; idempotent across repeat failures)."""
        stats = self._sched_stats
        stats["stripe_errors"][idx] += 1
        if not self._quarantined[idx]:
            self._quarantined[idx] = True
            stats["quarantines"] += 1
            telemetry.emit(
                "stripe_quarantine", stripe=idx, op=op_name,
                error=repr(exc)[:200],
            )
        Logger.warn(
            f"striped {op_name}: stripe {idx} failed ({exc!r}); quarantined, "
            "reconnecting in background — survivors drain the batch"
        )
        live = self._revive_tasks.get(idx)
        if live is not None and not live.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync teardown): the next op's sweep retries
        task = loop.create_task(self._revive(idx))
        self._revive_tasks[idx] = task

    async def _revive(self, idx: int, base_delay: float = 0.05, max_delay: float = 2.0):
        """Background reconnect loop for a quarantined stripe: exponential
        backoff until the server takes the connection again, then re-alias
        stripe 0's live shm segments (the reconnect dropped this stripe's
        registrations of them) and rejoin the fan-out."""
        delay = base_delay
        conn = self.conns[idx]
        loop = asyncio.get_running_loop()
        while self._quarantined[idx] and not self._striped_closed:
            if getattr(conn, "_closed", False):
                return  # operator close() is final; stay quarantined
            try:
                await loop.run_in_executor(None, conn.reconnect)
            # Audited: this loop IS the degrade policy — the stripe stays
            # quarantined and the reconnect retries on exponential backoff.
            except InfiniStoreException:  # its: allow[ITS-P001]
                await asyncio.sleep(delay)
                delay = min(delay * 2.0, max_delay)
                continue
            if self._rejoin(idx):
                Logger.warn(
                    f"striped: stripe {idx} reconnected; rejoining the fan-out"
                )
            return

    def _rejoin(self, idx: int) -> bool:
        """Restore a reconnected stripe to the fan-out: re-register any of
        stripe 0's live shm segments this stripe lost (its reconnect dropped
        the alias registrations; ones it still holds are skipped, so a
        rejoin after a non-reset error never double-registers), then clear
        the quarantine flag. Shared by the background revive and the
        op-entry sweep — without the alias step on BOTH paths, an
        externally-reconnected stripe would rejoin, fail its first shm-base
        chunk, and flap back into quarantine every batch."""
        conn = self.conns[idx]
        if idx != 0:
            have = {p for p, _ in getattr(conn, "_segment_aliases", [])}
            for buf in list(self.conns[0]._shm_bufs):
                if buf.ctypes.data in have:
                    continue
                try:
                    conn._register_segment_alias(buf.ctypes.data, buf.nbytes)
                # Audited: returning False keeps the stripe quarantined and
                # the revive loop retrying — the degrade policy for stripes.
                except InfiniStoreException:  # its: allow[ITS-P001]
                    return False  # died again; stay quarantined, revive retries
        if self._quarantined[idx]:
            self._quarantined[idx] = False
            self._sched_stats["rejoins"] += 1
            telemetry.emit("stripe_revive", stripe=idx)
        return True

    def _sweep_quarantine(self):
        """Op-entry sweep: pick up stripes healed out-of-band (an external
        reconnect) and restart revive tasks that died without rejoining."""
        for idx, bad in enumerate(self._quarantined):
            if not bad:
                continue
            if self.conns[idx].is_connected and self._rejoin(idx):
                continue
            live = self._revive_tasks.get(idx)
            if live is None or live.done():
                try:
                    loop = asyncio.get_running_loop()
                except RuntimeError:
                    continue
                self._revive_tasks[idx] = loop.create_task(self._revive(idx))

    def _live_stripes(self) -> List[int]:
        return [i for i, bad in enumerate(self._quarantined) if not bad]

    async def _adaptive_op(
        self, meth_name: str, blocks, block_size: int, ptr: int,
        priority: int = PRIORITY_FOREGROUND,
    ):
        """Fan one batched op out over the live stripes via the shared
        descriptor queue. Every worker settles (its in-flight native op
        completes) before this raises: a fail-fast would hand control back
        to a caller who may free the staging buffer while sibling stripes
        are still scatter/gathering from it in the native reactor.

        ``priority``: a BACKGROUND op's workers defer each pull while
        FOREGROUND ops are in flight (aging-bounded, see _bg_throttle) and
        pull bounded spans, so foreground work jumps the stripe queue; the
        tag also rides each chunk's wire op for the server-side scheduler.

        A stripe that dies with a TRANSPORT error hands its claimed span
        back to the queue and is quarantined (background reconnect); the
        survivors drain the remainder, so the batch completes — byte-
        complete — whenever at least one stripe lives. Only when EVERY
        stripe is gone with work still queued does the op raise."""
        self._sweep_quarantine()
        descs = deque(wire.chunk_spans(len(blocks), self.CHUNK_QUANTUM_BLOCKS))
        remaining = [len(blocks)]  # cell: workers mutate between awaits
        stats = self._sched_stats
        fatal: list = []  # (idx, exc): semantic failure — abort the batch
        handed_off: list = []  # (idx, exc): quarantined, span requeued

        async def worker(idx: int, conn: InfinityConnection):
            bound = getattr(conn, meth_name)
            pri_kw = wire.qos_kwargs(conn, priority)
            pulls = 0
            while descs and not fatal:
                if priority:
                    await self._bg_throttle()
                    if not descs or fatal:
                        break
                take = self._pull_blocks(idx, remaining[0], block_size, priority)
                # Pop whole quanta without yielding: consecutive descriptors
                # are contiguous by construction, so the merged span is one
                # contiguous run of the original batch.
                first = descs.popleft()
                start, count = first.start, first.count
                while count < take and descs:
                    count += descs.popleft().count
                remaining[0] -= count
                chunk = blocks[start : start + count]
                # Trace: each claimed span is a child span of the batched
                # op's — `stripe_claim` marks the moment this stripe took
                # the work; the chunk's own wire op stamps submit/
                # completion_ring under it (docs/observability.md).
                chunk_span = tracing.start_span(f"{meth_name}:chunk")
                if chunk_span is not None:
                    chunk_span.stage("stripe_claim")
                    chunk_span.annotate(stripe=idx, start=start, count=count)
                t0 = time.perf_counter()
                try:
                    with tracing.use_span(chunk_span):
                        await bound(chunk, block_size, ptr, **pri_kw)
                except BaseException as e:
                    if chunk_span is not None:
                        chunk_span.finish(status=f"error:{type(e).__name__}")
                    if self._is_stripe_transport_error(e):
                        # Give the claimed span back (quantum granularity,
                        # so the survivors' tail splitting stays fine) and
                        # leave the pool.
                        for d in reversed(wire.chunk_spans(
                            count, self.CHUNK_QUANTUM_BLOCKS
                        )):
                            descs.appendleft(wire.ChunkDesc(
                                seq=first.seq, start=start + d.start,
                                count=d.count,
                            ))
                        remaining[0] += count
                        stats["requeued_blocks"] += count
                        handed_off.append((idx, e))
                        self._quarantine(idx, e, meth_name)
                    else:
                        fatal.append((idx, e))
                    return
                if chunk_span is not None:
                    chunk_span.finish()
                dt = time.perf_counter() - t0
                if dt > 0:
                    bps = count * block_size / dt
                    prev = self._ewma_bps[idx]
                    self._ewma_bps[idx] = (
                        bps if prev <= 0
                        else self.EWMA_ALPHA * bps + (1 - self.EWMA_ALPHA) * prev
                    )
                pulls += 1
                stats["chunks"] += 1
                stats["stripe_chunks"][idx] += 1
                stats["stripe_blocks"][idx] += count
            if pulls > 1:
                stats["steals"] += pulls - 1

        if not self._live_stripes():
            raise InfiniStoreException(
                f"{meth_name}: all {len(self.conns)} stripes quarantined "
                "(reconnects pending)"
            )
        # Rounds, not one pass: a sibling that drained the visible queue and
        # exited cannot see the span a still-in-flight dying stripe hands
        # back AFTERWARDS — so while spans remain and live stripes exist,
        # the survivors re-enter. Each extra round implies a fresh
        # quarantine (that is the only way spans outlive a round), so this
        # terminates within `streams` rounds.
        while True:
            live = self._live_stripes()
            if not live:
                _, err0 = handed_off[-1]
                raise InfiniStoreException(
                    f"{meth_name}: batch incomplete — every stripe failed "
                    f"({remaining[0]} of {len(blocks)} blocks undelivered)"
                ) from err0
            await asyncio.gather(*(worker(i, self.conns[i]) for i in live))
            if fatal:
                idx0, err0 = fatal[0]
                for idx, e in fatal[1:] + handed_off:
                    stats["suppressed_errors"] += 1
                    Logger.warn(
                        f"striped {meth_name}: suppressed stripe-{idx} error "
                        f"behind stripe-{idx0}'s: {e!r}"
                    )
                raise err0
            if not descs:
                return wire.STATUS_OK

    async def _gather_settled(self, coros, meth_name: str):
        """Run the per-stripe chunk ops to completion — ALL of them — before
        raising (see _adaptive_op for why; this is the static-split
        variant's settle barrier)."""
        results = await asyncio.gather(*coros, return_exceptions=True)
        errors = [
            (i, r) for i, r in enumerate(results) if isinstance(r, BaseException)
        ]
        if errors:
            idx0, err0 = errors[0]
            for idx, e in errors[1:]:  # don't silently drop sibling failures
                self._sched_stats["suppressed_errors"] += 1
                Logger.warn(
                    f"striped {meth_name}: suppressed stripe-{idx} error "
                    f"behind stripe-{idx0}'s: {e!r}"
                )
            raise err0
        return results[0]

    def _first_live_conn(self) -> "InfinityConnection":
        """Stripe 0 unless it is quarantined, else the first live stripe —
        a small op must not fail just because one PARTICULAR stripe is down
        while siblings live. With every stripe quarantined, stripe 0 takes
        the op (and its transport error) as the honest answer."""
        for i, bad in enumerate(self._quarantined):
            if not bad:
                return self.conns[i]
        return self.conns[0]

    async def _bg_direct(self, conn, meth_name: str, blocks, block_size: int, ptr: int):
        """BACKGROUND op on a single connection (small / same-host-collapsed
        paths): one stripe-level deferral point, then the whole batch rides
        the underlying connection's own background machinery — which
        already splits it into bounded sub-batches and gates each one
        (InfinityConnection._batch_op). Splitting here too would stack a
        second aging-bounded wait per chunk and double-count the ledger."""
        await self._bg_throttle()
        self._sched_stats["bg_subbatches"] += 1
        bound = getattr(conn, meth_name)
        return await bound(
            blocks, block_size, ptr, **wire.qos_kwargs(conn, PRIORITY_BACKGROUND)
        )

    async def _batched(
        self, meth_name: str, blocks, block_size: int, ptr: int,
        priority: int = PRIORITY_FOREGROUND,
    ):
        stats = self._sched_stats
        stats["batched_ops"] += 1
        stats["bg_ops" if priority else "fg_ops"] += 1
        if not priority:
            self._fg_pending += 1
        try:
            if len(self.conns) == 1 or len(blocks) < 2 * len(self.conns):
                # Too small to be worth splitting: fan-out would only add
                # per-op round trips.
                stats["small_ops"] += 1
                self._sweep_quarantine()
                conn = self._first_live_conn()
                if priority:
                    return await self._bg_direct(
                        conn, meth_name, blocks, block_size, ptr
                    )
                return await getattr(conn, meth_name)(blocks, block_size, ptr)
            if self.adaptive:
                if self.memcpy_bound():
                    # Same host, memcpy data plane: one stream IS the
                    # ceiling — ride stripe 0's one-RTT segment path whole,
                    # so striping can never lose to a single stream.
                    stats["collapsed_ops"] += 1
                    if priority:
                        return await self._bg_direct(
                            self.conns[0], meth_name, blocks, block_size, ptr
                        )
                    return await getattr(self.conns[0], meth_name)(
                        blocks, block_size, ptr
                    )
                return await self._adaptive_op(
                    meth_name, blocks, block_size, ptr, priority
                )
            chunks = self._split(blocks)
            return await self._gather_settled(
                (
                    getattr(c, meth_name)(
                        chunk, block_size, ptr, **wire.qos_kwargs(c, priority)
                    )
                    for c, chunk in zip(self.conns, chunks)
                ),
                meth_name,
            )
        finally:
            if not priority:
                self._fg_pending -= 1

    async def rdma_write_cache_async(
        self, blocks, block_size: int, ptr: int,
        priority: int = PRIORITY_FOREGROUND,
    ):
        """Batched block write fanned out across stripes by the adaptive
        scheduler (write_cache_async is the TPU-native alias). A
        BACKGROUND-tagged op yields the stripes to concurrent FOREGROUND
        ops (aging-bounded — see docs/qos.md)."""
        return await self._batched(
            "write_cache_async", blocks, block_size, ptr, priority
        )

    async def rdma_read_cache_async(
        self, blocks, block_size: int, ptr: int,
        priority: int = PRIORITY_FOREGROUND,
    ):
        """Batched block read fanned out across stripes (read_cache_async is
        the TPU-native alias); KeyNotFound on any stripe raises after all
        in-flight chunk ops settle. ``priority``: see
        rdma_write_cache_async."""
        return await self._batched(
            "read_cache_async", blocks, block_size, ptr, priority
        )

    write_cache_async = rdma_write_cache_async
    read_cache_async = rdma_read_cache_async

    def preferred_fanout_blocks(self) -> int:
        """Sizing hint for batch assemblers (connector.FetchCoalescer): the
        most blocks one batched call can usefully carry — every stripe
        pulling its per-trip maximum once. Beyond this, merging more blocks
        into a single call buys no extra parallelism; it only coarsens the
        caller's failure/retry granularity."""
        return len(self.conns) * self.MAX_CHUNK_BLOCKS

    def data_plane_stats(self) -> dict:
        """Scheduler observability — the counters the bench's chaos
        receipts and the quarantine tests pin:

        - ``streams``, ``adaptive`` — fan-out shape;
        - ``batched_ops``, ``collapsed_ops`` (same-host detector sent the
          op to stripe 0), ``small_ops`` (below the split threshold),
          ``chunks``, ``steals`` (pulls beyond each worker's first),
          ``stripe_chunks``/``stripe_blocks`` per stripe,
          ``stripe_ewma_gbps`` measured per-stripe rates;
        - failure domain: ``stripe_errors``, ``requeued_blocks``,
          ``quarantines``/``rejoins``, current ``quarantined`` flags,
          ``suppressed_errors`` (sibling failures a raised batch absorbed);
        - ``qos``: ``fg_ops``/``bg_ops``, ``bg_deferred_pulls``,
          ``bg_aged_pulls``, ``bg_subbatches``, live ``fg_pending``."""
        s = self._sched_stats
        return {
            "streams": len(self.conns),
            "adaptive": self.adaptive,
            "batched_ops": s["batched_ops"],
            "collapsed_ops": s["collapsed_ops"],
            "small_ops": s["small_ops"],
            "chunks": s["chunks"],
            "steals": s["steals"],
            "stripe_chunks": list(s["stripe_chunks"]),
            "stripe_blocks": list(s["stripe_blocks"]),
            "stripe_ewma_gbps": [round(b / (1 << 30), 4) for b in self._ewma_bps],
            "stripe_errors": list(s["stripe_errors"]),
            "requeued_blocks": s["requeued_blocks"],
            "quarantines": s["quarantines"],
            "rejoins": s["rejoins"],
            "quarantined": list(self._quarantined),
            "suppressed_errors": s["suppressed_errors"],
            # Per-class QoS ledger (docs/qos.md): op counts, background
            # deferrals behind foreground work, aged-out deferrals, and
            # background sub-batches on the direct paths.
            "qos": {
                "fg_ops": s["fg_ops"],
                "bg_ops": s["bg_ops"],
                "bg_deferred_pulls": s["bg_deferred_pulls"],
                "bg_aged_pulls": s["bg_aged_pulls"],
                "bg_subbatches": s["bg_subbatches"],
                "fg_pending": self._fg_pending,
            },
        }

    def completion_stats(self) -> dict:
        """Aggregate async-bridge coalescing counters across stripes (see
        InfinityConnection.completion_stats)."""
        out = {
            "completions": 0,
            "wakeups_signalled": 0,
            "loop_wakeups": 0,
            "loop_drained": 0,
            "bridge_poll_hits": 0,
            "bridge_poll_arms": 0,
            "bridge_poll_drained": 0,
        }
        for c in self.conns:
            st = c.completion_stats()
            for k in out:
                out[k] += st[k]
        out["completion_batch_size"] = (
            out["completions"] / out["wakeups_signalled"]
            if out["wakeups_signalled"]
            else 0.0
        )
        return out

    def write_cache(self, blocks, block_size: int, ptr: int,
                    priority: int = PRIORITY_FOREGROUND):
        """Sync ops ride stripe 0: a blocking single-block op gains nothing
        from fanning out, and stripe 0 owns the shm segment (one-RTT path).
        The tag is forwarded via qos_kwargs, so a priority-unaware stripe-0
        stand-in degrades to untagged instead of TypeError'ing."""
        return self.conns[0].write_cache(
            blocks, block_size, ptr, **wire.qos_kwargs(self.conns[0], priority)
        )

    def read_cache(self, blocks, block_size: int, ptr: int,
                   priority: int = PRIORITY_FOREGROUND):
        """Blocking batched read on stripe 0 (see write_cache)."""
        return self.conns[0].read_cache(
            blocks, block_size, ptr, **wire.qos_kwargs(self.conns[0], priority)
        )

    # -- control / single-key ops: stripe 0 ----------------------------------

    def tcp_write_cache(self, key, ptr, size, **kw):
        """Single-key blocking put (stripe 0)."""
        return self.conns[0].tcp_write_cache(key, ptr, size, **kw)

    def tcp_read_cache(self, key, **kw):
        """Single-key blocking get (stripe 0); returns a numpy view."""
        return self.conns[0].tcp_read_cache(key, **kw)

    def check_exist(self, key):
        """True when the key is committed in the store (stripe 0)."""
        return self.conns[0].check_exist(key)

    def get_match_last_index(self, keys):
        """Longest-prefix match over a key chain (stripe 0); raises
        InfiniStoreNoMatch when nothing matches."""
        return self.conns[0].get_match_last_index(keys)

    def delete_keys(self, keys):
        """Delete keys from the store; returns the count removed (stripe 0)."""
        return self.conns[0].delete_keys(keys)

    def get_stats(self):
        """Server-side per-op stats snapshot as a dict (stripe 0)."""
        return self.conns[0].get_stats()


# ---------------------------------------------------------------------------
# Server control plane (module-level, mirroring the reference's globals:
# register_server lib.py:203, evict_cache :232, purge_kv_map :190,
# get_kvmap_len :177).
# ---------------------------------------------------------------------------

_server_handle = None
_server_lock = threading.Lock()


def register_server(loop, config: ServerConfig):
    """Start the native store server.

    Signature kept for drop-in compatibility with the reference
    (register_server(loop, config), lib.py:203). The loop argument is accepted
    and ignored: the reference had to graft libuv onto uvloop's uv_loop_t via
    PyCapsule (lib.py:217-229) because its data plane shared the Python
    thread; our native server owns a dedicated epoll reactor thread, so
    nothing needs to be spliced into asyncio.
    """
    global _server_handle
    config.verify()
    with _server_lock:
        if _server_handle is not None:
            raise InfiniStoreException("server already registered in this process")
        Logger.set_log_level(config.log_level)
        handle = lib.its_server_create(
            config.host.encode(),
            config.service_port,
            config.prealloc_bytes,
            config.block_bytes,
            1 if config.auto_increase else 0,
            config.extend_bytes,
            1 if config.pin_memory else 0,
            config.on_demand_evict_min,
            config.on_demand_evict_max,
            1 if config.enable_shm else 0,
            config.pacing_rate_mbps,
            config.spill_dir.encode(),
            config.spill_bytes,
        )
        if not handle:
            raise InfiniStoreException("failed to create server (allocation failed?)")
        if lib.its_server_start(handle) != 0:
            lib.its_server_destroy(handle)
            raise InfiniStoreException(
                f"failed to bind {config.host}:{config.service_port}"
            )
        _server_handle = handle
    return _server_handle


@dataclass
class LocalServer:
    """Handle to an in-process server started by ``start_local_server``."""

    handle: object
    port: int
    _stopped: bool = False

    def stop(self):
        """Stop the reactor and free the pools (idempotent)."""
        if not self._stopped:
            self._stopped = True
            lib.its_server_stop(self.handle)
            lib.its_server_destroy(self.handle)


def start_local_server(
    *,
    host: str = "127.0.0.1",
    service_port: int = 0,
    prealloc_bytes: int = 256 << 20,
    block_bytes: int = 64 << 10,
    auto_increase: bool = False,
    extend_bytes: int = 0,
    pin_memory: bool = False,
    evict_min: float = 0.8,
    evict_max: float = 0.95,
    enable_shm: bool = True,
    pacing_rate_mbps: int = 0,
    spill_dir: str = "",
    spill_bytes: int = 0,
):
    """Start an anonymous in-process server; returns a ``LocalServer``.

    Byte-granular convenience wrapper over the C API for tests, benchmarks,
    and self-contained examples (``register_server`` is the reference-shaped
    GB-granular entry point for the one long-lived server per process). The
    result carries ``.port``, the raw ``.handle`` for C-API introspection,
    and ``.stop()`` which shuts the reactor down and frees the pools.
    """
    handle = lib.its_server_create(
        host.encode(),
        service_port,
        prealloc_bytes,
        block_bytes,
        1 if auto_increase else 0,
        extend_bytes,
        1 if pin_memory else 0,
        evict_min,
        evict_max,
        1 if enable_shm else 0,
        pacing_rate_mbps,
        spill_dir.encode(),
        spill_bytes,
    )
    if not handle:
        raise InfiniStoreException("failed to create server (allocation failed?)")
    if lib.its_server_start(handle) != 0:
        lib.its_server_destroy(handle)
        raise InfiniStoreException(f"failed to bind {host}:{service_port}")
    return LocalServer(handle=handle, port=lib.its_server_port(handle))


def unregister_server():
    """Stop and destroy the in-process server (teardown helper; the reference
    relies on process exit)."""
    global _server_handle
    with _server_lock:
        if _server_handle is not None:
            lib.its_server_stop(_server_handle)
            lib.its_server_destroy(_server_handle)
            _server_handle = None


def _require_server():
    if _server_handle is None:
        raise InfiniStoreException("no server registered in this process")
    return _server_handle


def get_kvmap_len() -> int:
    return int(lib.its_server_kvmap_len(_require_server()))


def purge_kv_map() -> int:
    return int(lib.its_server_purge(_require_server()))


def evict_cache(min_threshold: float, max_threshold: float) -> int:
    return int(lib.its_server_evict(_require_server(), min_threshold, max_threshold))


def get_server_stats() -> dict:
    buf = ctypes.create_string_buffer(256 << 10)
    n = lib.its_server_stats_json(_require_server(), buf, len(buf))
    if n < 0:
        raise InfiniStoreException("stats query failed")
    return json.loads(buf.value.decode())
