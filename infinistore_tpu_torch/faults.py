"""Deterministic fault injection for the store data plane.

Copy of ``infinistore_tpu/faults.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step.

Chaos tests need failures that are *scripted*, not lucky: "the 3rd batched
read times out", "every op touching keys of family B sees a connection
reset", "op #40 returns a short read". This module is that harness — a
connection wrapper (:class:`FaultyConnection`) that intercepts every data-
and control-plane op of an ``InfinityConnection``-shaped object and fires
:class:`FaultRule` actions by op index, op name, and key pattern, with any
randomness drawn from one seeded generator so a failing chaos run replays
bit-for-bit from its seed.

The wrapper is surface-transparent: everything it does not fault passes
through (``__getattr__``), so it slots anywhere a real connection goes — a
``KVConnector`` member inside a ``ClusterKVConnector``, one stripe of a
``StripedConnection`` (via ``conn_factory``), or a bare test client. The
breaker / failover / quarantine machinery under test cannot tell injected
faults from real ones because the injected faults ARE real where it
matters: a ``reset`` severs the native transport (:func:`kill_transport`),
so liveness checks, auto-reconnect, and half-open probes all exercise their
true paths.

Every fire is recorded in ``FaultyConnection.fired`` (op index, op name,
action, keys) so tests assert exactly which faults a run took.
"""

import asyncio
import os
import random
import re
import signal
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

from ._native import lib
from .lib import InfiniStoreException, Logger

__all__ = [
    "FaultRule", "FaultyConnection", "kill_transport", "crash_process",
]


def crash_process() -> None:
    """Hard-kill THIS process (``SIGKILL`` to self): the process-level
    crash capability — a ``kill -9`` as the process experiences it, at a
    point the caller controls. No atexit handlers, no flushes, no
    destructors run; whatever the durable journal had not written is
    lost, which is exactly what crash-recovery tests must survive
    (docs/membership.md, durability section).

    Used by the ``"crash"`` :class:`FaultRule` action and by the fleet
    harness's crash-after-N-migrated-roots watcher
    (the JAX package's ``fleet_client``); the kill/restart-with-same-argv
    counterparts live in ``tools/fleet.py``. Never call this from a test
    process itself — spawn a subprocess and crash THAT.
    """
    Logger.warn("faults: crash_process() — SIGKILL to self")
    os.kill(os.getpid(), signal.SIGKILL)


def kill_transport(conn) -> bool:
    """Sever a connection's native transport WITHOUT ``close()``'s finality.

    In-flight ops fail out, ``is_connected`` goes False, shm segment views
    die (their ranges are marked dead so stale-pointer retries get the typed
    shm error) — but the connection object stays usable: ``reconnect()`` and
    the ``auto_reconnect`` self-heal path still work. This is a peer reset /
    node death as the client experiences it, not an operator shutdown.

    Returns True when a live transport was actually severed.
    """
    leftovers: list = []
    with conn._lock:
        if conn._handle is None:
            return False
        was_live = lib.its_conn_connected(conn._handle) == 1
        # Native close() is idempotent: reconnect()/close() re-closing this
        # handle later is safe, and the handle is destroyed only by close().
        # Audited: fault injection severs the transport INLINE by design —
        # a reset fault must land at a deterministic point in the op stream,
        # and the close is a local teardown, not a store round trip.
        lib.its_conn_close(conn._handle)  # its: allow[ITS-L001]
        leftovers = conn._drain_ring_locked(conn._handle)
        # The native close unmapped shm segments: existing views now cover
        # unmapped memory — same bookkeeping reconnect() does.
        conn._dead_shm_ranges += [
            (b.ctypes.data, b.nbytes) for b in conn._shm_bufs
        ] + list(conn._segment_aliases)
        conn._shm_bufs.clear()
        conn._segment_aliases.clear()
        conn.rdma_connected = False
        conn.tcp_connected = False
    conn._dispatch_completions(leftovers)
    return was_live


@dataclass
class FaultRule:
    """One scripted fault: WHERE it fires (op name / key pattern / op index
    schedule) and WHAT it does.

    Matching (all given conditions must hold):

    - ``op``: op name (e.g. ``"read_cache_async"``) or a collection of
      names; None matches every op.
    - ``key_pattern``: regex searched against each key the op touches
      (batched block lists, single-key ops, key chains); fires when ANY key
      matches. None matches ops regardless of keys (including keyless ops).
    - ``after``: global op index (per-connection counter over ALL
      intercepted ops) before which the rule never fires.
    - ``op_indices``: explicit global op indices to fire on.
    - ``every``: fire on every Nth *matching* op (1 = each one).
    - ``probability``: fire with this probability, drawn from the
      connection's single seeded generator (deterministic per seed).
    - ``max_fires``: total fires before the rule disarms (None = unbounded).

    Actions:

    - ``"error"``: raise :class:`InfiniStoreException` immediately.
    - ``"timeout"``: sleep ``delay_s`` (op time passes, like a real timeout
      burning its budget), then raise :class:`InfiniStoreException`.
    - ``"delay"``: sleep ``delay_s``, then run the op normally (slow op,
      not a failure).
    - ``"reset"``: sever the underlying transport (:func:`kill_transport`),
      then raise — the connection is really down afterwards; recovery
      requires (auto-)reconnect, exactly like a node death.
    - ``"short_read"``: ``tcp_read_cache`` returns only the first
      ``truncate_to`` bytes of the real payload; on every other op it
      raises (a batched op cannot deliver partial bytes without lying).
    - ``"crash"``: hard-kill the WHOLE process (:func:`crash_process`,
      SIGKILL to self) at this exact op — a deterministic ``kill -9``
      mid-operation for crash-recovery tests. Only meaningful inside a
      subprocess the test harness spawned (tools/fleet.py restarts it
      with the same argv).
    """

    op: Optional[Union[str, Sequence[str]]] = None
    key_pattern: Optional[str] = None
    after: int = 0
    op_indices: Optional[Sequence[int]] = None
    every: Optional[int] = None
    probability: float = 1.0
    action: str = "error"
    delay_s: float = 0.0
    truncate_to: Optional[int] = None
    max_fires: Optional[int] = None
    # Fires this rule has taken (mutated by the wrapper).
    fires: int = field(default=0, repr=False)
    # Matching ops seen (drives ``every``; mutated by the wrapper).
    matches: int = field(default=0, repr=False)

    _ACTIONS = ("error", "timeout", "delay", "reset", "short_read", "crash")

    def __post_init__(self):
        if self.action not in self._ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        if isinstance(self.op, str):
            self.op = (self.op,)
        elif self.op is not None:
            self.op = tuple(self.op)
        self._key_re = re.compile(self.key_pattern) if self.key_pattern else None

    def wants(self, index: int, op: str, keys: Sequence[str], rng) -> bool:
        """Does this rule fire on op ``index`` named ``op`` over ``keys``?
        Stateful: counts matches (for ``every``) and fires."""
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.op is not None and op not in self.op:
            return False
        if index < self.after:
            return False
        if self._key_re is not None and not any(
            self._key_re.search(k) for k in keys
        ):
            return False
        self.matches += 1
        if self.op_indices is not None and index not in self.op_indices:
            return False
        if self.every is not None and (self.matches - 1) % self.every != 0:
            return False
        if self.probability < 1.0 and rng.random() >= self.probability:
            return False
        self.fires += 1
        return True


class FaultyConnection:
    """``InfinityConnection``-shaped wrapper that injects :class:`FaultRule`
    faults into every intercepted op; everything else passes through to the
    wrapped connection untouched.

    One global op counter indexes every intercepted op (data and control),
    so a script like "rule fires at op 7" is stable across sync/async mixes.
    ``fired`` is the audit log: a list of ``{"index", "op", "action",
    "keys"}`` dicts, in firing order.
    """

    # Ops intercepted (everything that talks to the server). Anything not
    # listed passes through __getattr__ unfaulted.
    _SYNC_OPS = (
        "write_cache", "read_cache", "tcp_write_cache", "tcp_read_cache",
        "check_exist", "get_match_last_index", "delete_keys", "get_stats",
    )
    _ASYNC_OPS = ("write_cache_async", "read_cache_async")

    def __init__(self, inner, rules: Sequence[FaultRule], seed: int = 0):
        # Concurrency contract (ITS-R, races.CLASS_EXEMPT): the op
        # counter, rule match state and audit log are deliberately
        # lock-free — each wrapped connection is driven by ONE test
        # thread, and a deterministic fault script requires a
        # deterministic op order anyway (two racing drivers would make
        # "fires at op #7" meaningless before any lock could help).
        self.inner = inner
        self.rules = list(rules)
        self.rng = random.Random(seed)
        self.op_index = 0
        self.fired: List[dict] = []

    # -- plumbing ------------------------------------------------------------

    @staticmethod
    def _keys_of(op: str, args, kwargs) -> List[str]:
        if not args:
            return []
        first = args[0]
        if op in ("write_cache", "read_cache", "write_cache_async",
                  "read_cache_async"):
            return [k for k, _ in first]
        if op in ("tcp_write_cache", "tcp_read_cache", "check_exist"):
            return [first]
        if op in ("get_match_last_index", "delete_keys"):
            return list(first)
        return []

    def _plan(self, op: str, args, kwargs) -> Optional[FaultRule]:
        """Claim this op's index and return the first rule that fires."""
        index = self.op_index
        self.op_index += 1
        for rule in self.rules:
            keys = self._keys_of(op, args, kwargs)
            if rule.wants(index, op, keys, self.rng):
                self.fired.append(
                    {"index": index, "op": op, "action": rule.action,
                     "keys": keys[:4]}
                )
                Logger.debug(
                    f"faults: op #{index} {op} -> injected {rule.action}"
                )
                return rule
        return None

    def _raise(self, rule: FaultRule, op: str):
        if rule.action == "crash":
            crash_process()  # SIGKILL: nothing below this line runs
        if rule.action == "reset":
            kill_transport(self.inner)
            raise InfiniStoreException(f"injected connection reset ({op})")
        if rule.action == "timeout":
            raise InfiniStoreException(f"injected timeout ({op}): status=503")
        raise InfiniStoreException(f"injected {rule.action} ({op})")

    def _apply_sync(self, op: str, args, kwargs):
        rule = self._plan(op, args, kwargs)
        fwd = getattr(self.inner, op)
        if rule is None:
            return fwd(*args, **kwargs)
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return fwd(*args, **kwargs)
        if rule.action == "timeout" and rule.delay_s:
            time.sleep(rule.delay_s)
        if rule.action == "short_read" and op == "tcp_read_cache":
            out = fwd(*args, **kwargs)
            n = rule.truncate_to if rule.truncate_to is not None else len(out) // 2
            return out[: max(0, n)]
        self._raise(rule, op)

    async def _apply_async(self, op: str, args, kwargs):
        rule = self._plan(op, args, kwargs)
        fwd = getattr(self.inner, op)
        if rule is None:
            return await fwd(*args, **kwargs)
        if rule.action == "delay":
            await asyncio.sleep(rule.delay_s)
            return await fwd(*args, **kwargs)
        if rule.action == "timeout" and rule.delay_s:
            await asyncio.sleep(rule.delay_s)
        self._raise(rule, op)

    # -- intercepted surface -------------------------------------------------

    def write_cache(self, *a, **kw):
        """Sync batched put, fault-checked then forwarded."""
        return self._apply_sync("write_cache", a, kw)

    def read_cache(self, *a, **kw):
        """Sync batched get, fault-checked then forwarded."""
        return self._apply_sync("read_cache", a, kw)

    def tcp_write_cache(self, *a, **kw):
        """Single-key put, fault-checked then forwarded."""
        return self._apply_sync("tcp_write_cache", a, kw)

    def tcp_read_cache(self, *a, **kw):
        """Single-key get, fault-checked then forwarded (the one op
        ``short_read`` truncates instead of raising)."""
        return self._apply_sync("tcp_read_cache", a, kw)

    def check_exist(self, *a, **kw):
        """Key presence probe, fault-checked then forwarded."""
        return self._apply_sync("check_exist", a, kw)

    def get_match_last_index(self, *a, **kw):
        """Longest-prefix match, fault-checked then forwarded."""
        return self._apply_sync("get_match_last_index", a, kw)

    def delete_keys(self, *a, **kw):
        """Key deletion, fault-checked then forwarded."""
        return self._apply_sync("delete_keys", a, kw)

    def get_stats(self, *a, **kw):
        """Server stats query, fault-checked then forwarded."""
        return self._apply_sync("get_stats", a, kw)

    async def write_cache_async(self, *a, **kw):
        """Async batched put, fault-checked then forwarded."""
        return await self._apply_async("write_cache_async", a, kw)

    async def read_cache_async(self, *a, **kw):
        """Async batched get, fault-checked then forwarded."""
        return await self._apply_async("read_cache_async", a, kw)

    # Reference-compatible aliases share the canonical ops' fault schedule.
    rdma_write_cache_async = write_cache_async
    rdma_read_cache_async = read_cache_async

    def __getattr__(self, name):
        # Everything not intercepted (connect/close/reconnect/register_mr/
        # config/is_connected/...) is the wrapped connection's own.
        return getattr(self.inner, name)
