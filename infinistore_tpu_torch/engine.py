"""Continuous-batching engine harness (port of ``infinistore_tpu/engine.py``,
whole, on torch tensors).

Many interleaved requests with overlapping prefixes against ONE shared paged
cache, block tables owned by the engine:

- ``EngineKVAdapter``: the connector surface an engine bolts onto, with a
  token-granular prefix probe at admission (``get_num_matched_tokens``),
  load/save keyed by the engine's physical block table, two-phase fetch
  (``start_fetch``/``install_kv``) and request drop; a thin veneer over
  ``KVConnector``.
- ``ContinuousBatchingHarness``: a scheduler-shaped harness. ``BlockPool``
  hands out physical blocks, prefix hits skip recompute, a resumed suffix is
  one chunked continuation (``prefill_continue``, kernel K3), a miss is one
  prefill (K4 attention, K2 cache write), saves snapshot their blocks with
  K1 and stream to the store with no lock held, and generation of every
  live request is coalesced into lockstep RAGGED waves (``WaveDecoder`` ->
  one ``verify_step_ragged`` call per wave, kernel K6; on a card, one
  CUDA graph replay per wave, a graph per row rung), optionally with
  n-gram speculative drafts riding the same waves.

Admission is TWO-PHASE and store I/O never holds the device gate: a
speculative, gate-free fetch (``KVConnector.start_fetch``) streams the hit
prefix into host staging at enqueue, concurrent admissions' reads coalesced
into shared store calls; only the short install (upload + K2 scatter) takes
the exclusive gate, in an expedited lane. Gate-held compute runs in executor
threads so the event loop keeps draining fetch completions; work a thread
queued on the card is synchronised in that thread before the gate is
released (the counterpart of the reference's ``block_until_ready``).

``device`` (default ``"cuda"``; raises without a card) is where the
harness's cache lives; the parameters must live there too. The metrics keep
the reference's ``engine_*`` vocabulary (``metrics()``).
"""

import asyncio
import contextvars
import operator
import time
from contextlib import asynccontextmanager, nullcontext
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import tracing
from .cuda import _ext
from .cuda.paged import gather_blocks, gather_blocks_many
from .cuda.paged_attention import build_ragged_wave
from .cuda.staging import StagingPoolExhausted
from .models.llama import LaunchCounts, prefill, prefill_continue, verify_step_ragged
from .wire import PRIORITY_BACKGROUND


def _int32_on(device, *arrays, out: Optional[tuple] = None):
    """Host int sequences -> int32 tensors on ``device`` in ONE copy (one
    host->device transfer per wave however many metadata arrays it has);
    each comes back in its own shape. ``out``: (host, target), int32
    buffers of exactly their total size (a captured wave's staging and
    static inputs): the arrays are packed into ``host`` and copied from it
    into ``target`` without waiting for the stream, so a pinned ``host``
    must stay unchanged until that copy has run."""
    arrs = [np.asarray(a, dtype=np.int32) for a in arrays]
    if out is None:
        flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrs])).to(device)
    else:
        host, flat = out
        np.concatenate([a.reshape(-1) for a in arrs], out=host.numpy())
        flat.copy_(host, non_blocking=True)
    out, off = [], 0
    for a in arrs:
        out.append(flat[off : off + a.size].view(a.shape))
        off += a.size
    return out


# The widest flat-row rung whose decode waves replay a CUDA graph (the top
# of prewarm_wave_buckets' default ladder); a wider wave runs eagerly.
GRAPH_MAX_ROWS = 64

# Slots of the waves' host ring for their device counters (LaunchCounts):
# a slot is read by its wave's requests right after their token copy, long
# before this many later waves reuse it.
COUNT_SLOTS = 64


class RoutingLog:
    """The routed experts every computed token chose, per routed layer, by
    the token sequence the token ends: the choice a later token's keys and
    values were made with. A model's config carries one
    (``LlamaConfig.routing_log``) where a caller wants the program's
    choices: the benchmark's reference takes them at its own near-ties. A
    sequence computed again keeps its last choice.

    Recording (``put``) appends a reference to the launch's rows; the keys
    (``link`` folds each token id into the hash of the ids before it) are
    made at the first ``lookup`` after it, so a step pays an append."""

    ROOT = 0

    def __init__(self):
        self._records: List[tuple] = []
        self._indexed = 0
        self._rows: dict = {}

    @staticmethod
    def link(prev: int, token: int) -> int:
        return hash((prev, int(token)))

    @classmethod
    def chain(cls, tokens) -> List[int]:
        """The key of every prefix of ``tokens``."""
        keys, h = [], cls.ROOT
        for t in tokens:
            h = cls.link(h, t)
            keys.append(h)
        return keys

    def put(self, tokens, start: int, choices: np.ndarray, ids=None) -> None:
        """``choices`` [n, layers, k]: the experts of the rows at positions
        ``start ..`` of ``tokens`` (a sequence that only grows: row i ends
        at ``tokens[start + i]``). ``ids``: the rows' own token ids where
        some may be drafts; the rows from the first that ``tokens`` did not
        take are dropped."""
        self._records.append((tokens, start, choices, ids))

    def _index(self) -> None:
        chains: dict = {}
        for tokens, start, choices, ids in self._records[self._indexed:]:
            n = min(len(choices), len(tokens) - start)
            if ids is not None:
                n = next((i for i in range(n) if tokens[start + i] != ids[i]), n)
            if n <= 0:
                continue
            chain = chains.get(id(tokens))
            if chain is None:
                chain = chains[id(tokens)] = self.chain(tokens)
            for i in range(n):
                self._rows[chain[start + i]] = choices[i]
        self._indexed = len(self._records)

    def lookup(self, tokens) -> Optional[np.ndarray]:
        """[len(tokens), layers, k] of the recorded choices, -1 where a
        prefix was never computed here; None before any record."""
        self._index()
        if not self._rows:
            return None
        shape = next(iter(self._rows.values())).shape
        out = np.full((len(tokens),) + shape, -1, dtype=np.int16)
        for p, key in enumerate(self.chain(tokens)):
            row = self._rows.get(key)
            if row is not None:
                out[p] = row
        return out


class DeviceCounts:
    """One request's share of the device counters (``LaunchCounts``) of the
    launches that computed it: ``pending`` (host slot, share, span, the
    launch's routed-expert choices on the host, the request's first row in
    them, where its rows lie in its token sequence) entries whose copy is
    queued behind the launch, and ``stamps``, (host time, expert reads,
    token pairs, most rows of one expert, keys skipped) once the request's
    next copy from the device has returned (which waits for the slot's copy
    too, so reading it adds no sync). A wave's counts are shared over its
    live rows (``share``: the request's rows over the wave's); the most rows
    of one expert is the launch's own. ``rows``: (the request's token
    sequence, the step's first position, the step's token ids) of its next
    step, for a config with a ``RoutingLog`` (set before the step)."""

    def __init__(self, log: Optional[RoutingLog] = None):
        self.log = log
        self.rows: Optional[tuple] = None
        self.pending: List[tuple] = []
        self.stamps: List[tuple] = []

    def settle(self, t: float) -> None:
        for slot, share, span, choices, first, rows in self.pending:
            reads, pairs, most, skipped = slot.tolist()
            if span is not None:
                span.annotate(**dict(zip(LaunchCounts.FIELDS, (reads, pairs, most, skipped))))
            self.stamps.append((t, reads * share, pairs * share, most, skipped * share))
            if self.log is not None and choices is not None and rows is not None:
                tokens, start, ids = rows
                # A copy: the ring's slot is reused.
                self.log.put(tokens, start, choices[first:first + len(ids)].numpy().copy(), ids)
        self.pending.clear()

    def totals(self) -> tuple:
        """(expert reads, token pairs, most rows, keys skipped) over the stamps."""
        if not self.stamps:
            return 0.0, 0.0, 0, 0.0
        cols = list(zip(*self.stamps))
        return sum(cols[1]), sum(cols[2]), max(cols[3]), sum(cols[4])


# The running request's DeviceCounts (set by run_request, read by the wave
# decoder's step_chunk in the same task).
_DEVICE_COUNTS: contextvars.ContextVar = contextvars.ContextVar(
    "its_device_counts", default=None)


def capture_cuda_graph(run, stream, pool):
    """Capture ``run()`` (one wave's model call, already run once on
    ``stream``) as a CUDA graph on ``stream``, its memory from ``pool``.
    Returns (graph, the output tensor its replays write). Only this thread
    is held to capture's rules: the KV writer's threads keep copying."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = run()
    return graph, out


@dataclass
class WaveGraph:
    """One row rung's captured wave: ``inputs`` (the static int32 buffer
    whose slices are the wave's tokens, positions, row_of, pages,
    page_rows, page_starts and tables) and ``staging``, its host copy
    (pinned on a card; ``copied`` marks when the last copy out of it ran),
    the ``graph``, the ``logits`` each replay writes, the ``launches`` per
    kernel its capture counted (added to ``_ext.LAUNCHES`` on every
    replay), the split workspace tensors its kernels point at (``keep``)
    and, for a model with counters, the [4] buffer each replay writes them
    to (``counts``) and, with a ``RoutingLog``, its expert choices'
    (``choices``)."""

    inputs: torch.Tensor
    staging: torch.Tensor
    copied: Optional[object]
    graph: object
    logits: torch.Tensor
    launches: dict
    keep: list
    counts: Optional[torch.Tensor] = None
    choices: Optional[torch.Tensor] = None


_DTYPE = operator.attrgetter("dtype")


def _wave_identity(params, caches) -> tuple:
    """What a captured wave's kernels read and write: every cache and
    parameter tensor, by address and by dtype."""
    tensors = [t for kv in caches for t in kv]
    tensors.extend(params.values())
    return tuple(map(torch.Tensor.data_ptr, tensors)), tuple(map(_DTYPE, tensors))


class WaveCounters:
    """Process-wide skew-aware wave-policy ledger (ITS-C010,
    docs/serving_load.md).

    The ``engine_wave_*`` vocabulary the manage plane's /metrics exporter
    re-serves (``server.py _engine_wave_prometheus_lines``) and ``GET
    /wave`` snapshots — kept in lockstep with both and with the
    serving-load docs by the counters checker. Per-harness figures live
    in ``ContinuousBatchingHarness.metrics``; this singleton aggregates
    across every decoder in the process so dashboards see engine flows
    without holding a harness reference. Key vocabulary (every key
    ``engine_wave_``-prefixed, documented in docs/serving_load.md):

    - ``engine_wave_deferrals``: chunks re-queued to ride a later wave
      because launching them now would bump the (T, P) bucket past the
      marginal-pad threshold.
    - ``engine_wave_aging_escapes``: deferred chunks force-launched
      because their deferral age crossed the QoS-aware starvation bound
      (``wave_defer_max_s``) — the proof deferral never starves.
    - ``engine_wave_held_flushes``: whole flushes held back by the EWMA
      wave-size target (a hot engine refusing a degenerate 1-row wave).
    - ``engine_wave_policy_waves``: waves launched with the policy on.
    - ``engine_wave_defer_age_us_p99``: p99 deferral age at launch.
    - ``engine_wave_bucket_occupancy``: real rows / launched rows over
      policy waves (1 - pad fraction — what the deferral rule raises).
    """

    def __init__(self):
        # Written only on the engine loop (the flush/launch path runs
        # there); the manage-plane server thread snapshots via status().
        # its: guard[_c, _ages_us, _real_rows, _launched_rows: single_writer]
        self._c = {
            # Requests re-queued to ride a later wave because launching
            # them now would bump the (T, P) bucket past the pad
            # threshold.
            "engine_wave_deferrals": 0,
            # Deferred requests force-launched because their deferral age
            # crossed the starvation bound (wave_defer_max_s, QoS-aware).
            "engine_wave_aging_escapes": 0,
            # Whole flushes held back by the EWMA wave-size target (a hot
            # engine refusing to launch a degenerate under-target wave).
            "engine_wave_held_flushes": 0,
            # Waves launched with the skew policy active.
            "engine_wave_policy_waves": 0,
        }
        self._ages_us: list = []
        self._real_rows = 0
        self._launched_rows = 0

    def bump(self, key: str, n: int = 1):
        self._c[key] += n

    def note_defer_age(self, age_us: float):
        """Record a previously-deferred entry's age at launch (bounded)."""
        if len(self._ages_us) < 8192:
            self._ages_us.append(age_us)

    def note_wave(self, real_rows: int, launched_rows: int):
        self._real_rows += real_rows
        self._launched_rows += launched_rows

    def status(self) -> dict:
        c = self._c
        ages = sorted(self._ages_us)
        p99 = ages[min(len(ages) - 1, int(len(ages) * 0.99))] if ages else 0.0
        return {
            "engine_wave_deferrals": c["engine_wave_deferrals"],
            "engine_wave_aging_escapes": c["engine_wave_aging_escapes"],
            "engine_wave_held_flushes": c["engine_wave_held_flushes"],
            "engine_wave_policy_waves": c["engine_wave_policy_waves"],
            # p99 deferral age at launch: how long the policy actually
            # parks a request (bounded by the starvation rule).
            "engine_wave_defer_age_us_p99": round(p99, 1),
            # Fraction of launched wave rows that were REAL (1 - pad
            # fraction), over policy-launched waves: the bucket-economics
            # figure the deferral rule exists to raise.
            "engine_wave_bucket_occupancy": (
                round(self._real_rows / self._launched_rows, 4)
                if self._launched_rows
                else 0.0
            ),
        }


_WAVE_COUNTERS = WaveCounters()


def wave_counters() -> WaveCounters:
    """The process-wide wave-policy ledger (see :class:`WaveCounters`)."""
    return _WAVE_COUNTERS


def reset_wave_counters() -> WaveCounters:
    """Fresh ledger (test isolation); returns the new one."""
    global _WAVE_COUNTERS
    _WAVE_COUNTERS = WaveCounters()
    return _WAVE_COUNTERS


class BlockPool:
    """Engine-owned physical block allocator (the block-table manager).

    ``alloc`` backpressures when the pool is exhausted — a request waits for
    blocks exactly as an engine scheduler defers admission, instead of
    failing."""

    def __init__(self, num_blocks: int):
        self._free = list(range(num_blocks - 1, -1, -1))
        self._cond = asyncio.Condition()

    @property
    def available(self) -> int:
        return len(self._free)

    async def alloc(self, n: int) -> np.ndarray:
        async with self._cond:
            await self._cond.wait_for(lambda: len(self._free) >= n)
            ids = [self._free.pop() for _ in range(n)]
        return np.asarray(ids, dtype=np.int32)

    async def free(self, ids: np.ndarray):
        async with self._cond:
            self._free.extend(int(i) for i in ids)
            self._cond.notify_all()


class DeviceGate:
    """Reader-writer discipline over the shared paged cache.

    Exclusive: phases that MUTATE the cache tensors in place (install
    scatters, prefill/decode writes) — two such phases interleaving at
    await points would tear a request's blocks. Shared: gather-only phases
    (save snapshots, verification reads) — they overlap each other freely
    and are over in microseconds, after which the actual store I/O runs
    with no gate held at all.

    Traced (``tracing``), each request for the gate is an ``engine.gate``
    span of the caller's ``kind`` (``install``, ``load``, ``prefill``,
    ``resume``, ``wave``; ``snapshot`` or ``verify`` for shared holders):
    opened at the request, ``acquire`` stamped when granted, closed at
    release, so wait = start -> ``acquire`` and hold = ``acquire`` -> end
    (a wait that is cancelled records no span). ``parent`` names the span
    it belongs to (default: the active span)."""

    def __init__(self):
        self._cond = asyncio.Condition()
        self._shared = 0
        self._exclusive = False
        # Writer priority: a waiting mutator blocks NEW shared holders, or a
        # steady stream of snapshot/verify phases could starve loads and
        # computes indefinitely. (Phases are never nested per request, so
        # priority cannot deadlock.)
        self._exclusive_waiting = 0
        # Expedite lane: short mutators (prefix INSTALLS — a device
        # transfer, not a model forward) go ahead of queued long ones
        # (prefills). Installs arrive LATE by construction (their gate-free
        # fetch runs first), so FIFO would park every cache hit behind a
        # convoy of misses' prefills — shortest-job-first keeps the hit
        # path's latency at install cost. No starvation in practice: each
        # admission expedites at most once, so the lane drains.
        self._expedite_waiting = 0

    @asynccontextmanager
    async def exclusive(self, expedite: bool = False, kind: str = "exclusive",
                        parent=None):
        span = tracing.start_span("engine.gate", parent=parent)
        if span is not None:
            span.annotate(kind=kind, exclusive=True)
        async with self._cond:
            self._exclusive_waiting += 1
            if expedite:
                self._expedite_waiting += 1
            try:
                await self._cond.wait_for(
                    lambda: not self._exclusive
                    and self._shared == 0
                    and (expedite or self._expedite_waiting == 0)
                )
            finally:
                self._exclusive_waiting -= 1
                if expedite:
                    self._expedite_waiting -= 1
                # A cancelled wait (e.g. a timed-out request) may be the
                # writer that shared() waiters queued behind; without this
                # notify they would sleep forever on a free gate.
                self._cond.notify_all()
            self._exclusive = True
        if span is not None:
            span.stage("acquire")
        try:
            yield
        finally:
            async with self._cond:
                self._exclusive = False
                self._cond.notify_all()
            if span is not None:
                span.finish()

    @asynccontextmanager
    async def shared(self, kind: str = "shared"):
        span = tracing.start_span("engine.gate")
        if span is not None:
            span.annotate(kind=kind, exclusive=False)
        async with self._cond:
            await self._cond.wait_for(
                lambda: not self._exclusive and self._exclusive_waiting == 0
            )
            self._shared += 1
        if span is not None:
            span.stage("acquire")
        try:
            yield
        finally:
            async with self._cond:
                self._shared -= 1
                if self._shared == 0:
                    self._cond.notify_all()
            if span is not None:
                span.finish()


class WaveDecoder:
    """Coalesce decode AND verify steps from concurrent requests into
    lockstep waves.

    A continuous-batching engine advances EVERY live request one step per
    wave with one batched model call. Each request awaits ``step(token,
    position, table)`` (one decode token) or ``step_chunk(tokens,
    positions, table)`` (a speculative-verification chunk: the committed
    token plus drafted continuations); the first arrival schedules a flush,
    the flush yields to the event loop so every ready request joins, then
    ONE ``verify_step_ragged`` call (under the device gate's exclusive
    phase — it mutates the shared cache) advances the whole MIXED wave.

    Wave assembly is RAGGED: the chunks are CONCATENATED into one flat
    token list (sum(len_i) rows, not B x max(len_i)). The flat list pads
    only at the TAIL to a power-of-two row bucket by repeating the last
    (token, position) row, which scatters the SAME K/V bytes to the same
    (block, slot). Request tables pad to a power-of-two B whose padded rows
    no flat token references. Attention page metadata
    (``cuda/paged_attention.py build_ragged_wave``) pads to a power-of-two
    page bucket; padded pages are never read. On CUDA the wave's attention
    is one launch of kernel K6 per layer over the flat page list.

    ``bucket_sizes`` records the distinct (B, T, P) launch shapes — table
    rows, flat token rows, flat attention pages; the harness test pins
    them to the power-of-two ladder. ``pad_rows``/``launched_rows`` feed
    ``engine_wave_pad_fraction``: 1 - sum(len_i) / T_bucket.

    **Wave == sequential, stated as a tolerance.** The reference promises
    that a mixed wave is bitwise equal to advancing each request alone. It
    does not hold on the reference's own CPU run, and on CUDA cuBLAS picks
    its GEMM algorithm by shape, so a wave's projections round differently
    from a one-request wave's. The port promises instead:

    - logits and cache values of a mixed wave equal sequential decode
      within 1e-5 absolute and relative in float32 (the port's tests hold
      both pins to this, on the CPU and on the card);
    - on the card, the attention of each row (kernel K6) is BITWISE
      independent of the wave around it: a row's output is the same in a
      solo launch and inside a mixed wave, and equals kernel K3 over the
      row's own table (``chip_smoke.py`` checks both).

    Greedy decoding therefore chooses the same tokens whenever the top two
    logits are further apart than the tolerance.

    **Skew-aware flush policy** (``skew_policy=True``, off by default):
    a blind first-arrival flush lets one 8:1-skew outlier bump the wave's
    (T, P) bucket and pad every other row. With the policy on, the flush
    PARTITIONS the taken batch: an entry whose rows/pages would bump the
    power-of-two bucket AND whose marginal pad cost exceeds
    ``defer_pad_frac`` rides the next wave — UNLESS its deferral age
    crossed the starvation bound (``defer_max_s`` for FOREGROUND entries,
    ``defer_max_bg_s`` for BACKGROUND ones), in which case it launches now
    (an *aging escape*). An EWMA arrival-rate wave-size target holds a
    degenerate under-target flush for up to ``hold_max_s`` while arrivals
    are hot. Deferred entries return to the FRONT of the queue and a timed
    kick guarantees a re-flush; each flush keeps at least its smallest
    entry, so progress is unconditional. The policy changes which wave a
    chunk rides, never what it computes beyond the tolerance above.

    **Canonical bucket ladder** (policy on): every launch lands on the
    declared bucket ``(T, T, T * max_req_blocks)`` — table rows pad to the
    flat-row rung (a padded table row neither scatters nor attends) and
    pages pad to the rung maximum (padded pages are never read), leaving T
    on its power-of-two ladder. The working set of launch shapes is then
    known at startup: ``ContinuousBatchingHarness.prewarm_wave_buckets``
    runs the ladder once before serving.

    **CUDA graphs** (on a card, rungs up to ``GRAPH_MAX_ROWS``): a wave's
    model call is some 78 kernel launches a layer, host work that held the
    loop and the gate far longer than the card computes. So every such
    wave lands on the canonical bucket too, policy on or off, and each rung
    replays one ``torch.cuda.CUDAGraph``. The first wave at a rung runs
    eagerly on the decoder's capture stream (it serves its rows and warms
    that stream's workspaces), then ``verify_step_ragged`` is captured
    there from a static int32 buffer whose slices are the wave's inputs;
    all rungs share one memory pool. A later wave copies its metadata into
    that buffer (one host->device copy through the rung's pinned staging,
    which does not wait for the stream), replays the graph under the
    exclusive gate, and copies its real logits rows out of the graph's
    output before any waiter sees them, so the next replay cannot change
    rows already served. Each graph keeps the split workspace it was
    captured with (``split_workspace`` may replace it with a larger one),
    and adds its capture's kernel launches to ``_ext.LAUNCHES`` at every
    replay. Graphs point at the cache and parameter tensors: when those
    are replaced, the graphs are dropped and the next wave at a rung
    captures again. A capture that fails raises. On the CPU, and above the
    top rung, every wave runs eagerly as before; ``graph_replays``,
    ``graph_captures`` and ``eager_waves`` count the three kinds.
    """

    def __init__(
        self,
        harness: "ContinuousBatchingHarness",
        skew_policy: bool = False,
        defer_max_s: float = 0.025,
        defer_max_bg_s: Optional[float] = None,
        defer_pad_frac: float = 0.25,
        hold_max_s: float = 0.002,
    ):
        self.h = harness
        self.skew_policy = skew_policy
        self.defer_max_s = defer_max_s
        # BACKGROUND entries tolerate 4x the deferral age by default: the
        # starvation bound is QoS-aware (docs/qos.md), so deferring a
        # heavy background outlier never costs a foreground TTFT.
        self.defer_max_bg_s = (
            defer_max_bg_s if defer_max_bg_s is not None else defer_max_s * 4
        )
        self.defer_pad_frac = defer_pad_frac
        self.hold_max_s = hold_max_s
        self._pending: List[tuple] = []
        self._flush_scheduled = False
        # Wave-row padding ledger (engine_wave_pad_fraction).
        self.pad_rows = 0
        self.launched_rows = 0
        # Skew-policy ledger (per-decoder; the process-wide WaveCounters
        # singleton aggregates the same events for /metrics).
        self.deferrals = 0
        self.aging_escapes = 0
        self.held_flushes = 0
        self.defer_ages_us: List[float] = []
        # EWMA of chunk inter-arrival seconds (policy on only): the
        # wave-size target is hold_max_s / interval — what a full hold
        # window would coalesce at the current arrival rate.
        self._ewma_interval: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._kick_handle = None
        # Strong references: the event loop holds only weak refs to tasks,
        # so a fire-and-forget flush could be GC'd mid-flight and strand
        # every waiter with _flush_scheduled stuck True. A SET, not a slot:
        # _flush clears _flush_scheduled before awaiting the gate, so a new
        # step() can legally start a second flush while the first is still
        # in flight — a single slot would drop the older task's reference.
        self._flush_tasks = set()
        # Traced only: a pending chunk's future -> (its request's trace id,
        # its enqueue stamp), read into the wave's span when taken.
        self._row_trace: dict = {}
        self.waves = 0
        self.max_wave = 0
        self.bucket_sizes = set()  # distinct PADDED (B, T, P) launch shapes
        # Canonical (B, T, P) buckets prewarm_wave_buckets ran at
        # startup — organic bucket_sizes stays launch-driven so the two
        # sets can be compared (serving must mint nothing beyond the
        # declared ladder with the policy on).
        self.prewarmed = set()
        # CUDA graphs (class docstring): ``capture`` makes one (None: every
        # wave eager) on the capture stream, from the rungs' shared memory
        # pool; rung -> WaveGraph, valid for the tensors whose identity is
        # _graph_identity.
        device = getattr(harness, "device", None) or harness.params["embed"].device
        on_card = device.type == "cuda"
        self.capture = capture_cuda_graph if on_card else None
        self._graph_stream = torch.cuda.Stream(device) if on_card else None
        self._graph_pool = torch.cuda.graph_pool_handle() if on_card else None
        self._graphs: dict = {}
        self._graph_identity = None
        self.graph_replays = 0
        self.graph_captures = 0
        self.eager_waves = 0
        # Device counters (models/llama.py LaunchCounts), for a model that
        # has them: each wave's [4] copied into a slot of the host ring
        # (pinned on a card) right after its launch; a pending chunk's
        # future -> (slot, its share of the wave's rows, the wave's span).
        self.counting = bool(getattr(harness.config, "counts_launches", False))
        self._count_ring = (torch.zeros((COUNT_SLOTS, 4), dtype=torch.int64,
                                        pin_memory=on_card) if self.counting else None)
        self._count_next = 0
        self._fut_counts: dict = {}
        # With a RoutingLog, each wave's routed-expert choices too, into a
        # host ring of the top rung's rows (pinned on a card).
        self.routing = (self.counting
                        and getattr(harness.config, "routing_log", None) is not None)
        self._on_card = on_card
        self._choice_ring = None

    async def step(
        self, token: int, position: int, padded_table, priority: int = 0
    ) -> torch.Tensor:
        """Advance this request by one token; returns its logits row."""
        rows = await self.step_chunk(
            [token], [position], padded_table, priority=priority
        )
        return rows[0]

    async def step_chunk(
        self,
        tokens: Sequence[int],
        positions: Sequence[int],
        padded_table,
        priority: int = 0,
    ) -> torch.Tensor:
        """Advance this request by a token chunk (tokens[0] committed,
        tokens[1:] speculative); returns its [len(tokens), vocab] logits
        rows — row j follows tokens[:j+1]. ``priority`` is the request's
        QoS class (wire.PRIORITY_*): the skew policy's starvation bound
        is tighter for FOREGROUND entries; with the policy off it is
        recorded and ignored."""
        if not tokens or len(tokens) != len(positions):
            raise ValueError("need non-empty tokens with matching positions")
        now = time.perf_counter()
        if self.skew_policy:
            if self._last_arrival is not None:
                dt = now - self._last_arrival
                self._ewma_interval = (
                    dt if self._ewma_interval is None
                    else 0.2 * dt + 0.8 * self._ewma_interval
                )
            self._last_arrival = now
        fut = asyncio.get_running_loop().create_future()
        # Entry layout: (tokens, positions, table, future, enqueue_t,
        # qos_priority, defer_count). The trailing three fields are
        # policy metadata — the policy-off path never reads them.
        self._pending.append(
            (list(tokens), list(positions), padded_table, fut, now, priority, 0)
        )
        rspan = tracing.active_span()
        if rspan is not None:
            self._row_trace[fut] = (rspan.trace_id, tracing.us_of_perf(now))
        if not self._flush_scheduled:
            self._flush_scheduled = True
            task = asyncio.ensure_future(self._flush())
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_tasks.discard)
        try:
            return await fut
        finally:
            entry = self._fut_counts.pop(fut, None)
            sink = _DEVICE_COUNTS.get()
            if entry is not None and sink is not None:
                sink.pending.append(entry + (sink.rows,))
                sink.rows = None

    def _counts_to_host(self, counts: torch.Tensor, choices: Optional[torch.Tensor]):
        """Queue the copy of a launch's [4] device counters (and its [rows,
        layers, k] expert choices) into the next slot of the host rings;
        a slot reads true once a later copy from the device on the stream
        has returned. Returns (counts slot, choices slot or None)."""
        i = self._count_next % COUNT_SLOTS
        self._count_next += 1
        slot = self._count_ring[i]
        slot.copy_(counts, non_blocking=True)
        if choices is None:
            return slot, None
        rows = choices.shape[0]
        ring = self._choice_ring
        if ring is None or ring.shape[1] < rows:
            # Grown only for a wave above the top rung; a slot still to be
            # read keeps the old ring alive.
            self._choice_ring = ring = torch.empty(
                (COUNT_SLOTS, max(rows, GRAPH_MAX_ROWS)) + tuple(choices.shape[1:]),
                dtype=choices.dtype, pin_memory=self._on_card)
        held = ring[i, :rows]
        held.copy_(choices, non_blocking=True)
        return slot, held

    # -- skew-aware flush policy (docs/serving_load.md) ---------------------

    def _defer_bound_s(self, priority: int) -> float:
        """Starvation bound for one entry's QoS class."""
        return (
            self.defer_max_bg_s if priority == PRIORITY_BACKGROUND
            else self.defer_max_s
        )

    def _target_rows(self) -> float:
        """EWMA wave-size target: the rows a full hold window would
        coalesce at the observed arrival rate (1.0 when idle/unknown —
        an idle engine never holds a flush)."""
        if not self._ewma_interval or self._ewma_interval <= 0:
            return 1.0
        return min(32.0, self.hold_max_s / self._ewma_interval)

    def _entry_pages(self, entry) -> int:
        """Attention pages this entry's flat rows contribute (the same
        per-row rule build_ragged_wave applies: ceil((pos+1)/bt))."""
        bt = self.h.config.block_tokens
        return sum(-(-(p + 1) // bt) for p in entry[1])

    def _partition(self, batch: List[tuple], now: float):
        """Split a taken batch into (take, defer) under the skew rule.

        Aged entries (deferral age past their QoS bound) always launch.
        Remaining entries are admitted smallest-chunk-first; one is
        deferred only when adding it bumps the power-of-two row or page
        bucket AND the resulting marginal pad fraction exceeds
        ``defer_pad_frac``. The first admitted entry is unconditional,
        so a flush with any entry at all always launches at least one —
        deferral can delay a chunk, never starve it."""
        aged, flex = [], []
        for e in batch:
            age = now - e[4]
            if age >= self._defer_bound_s(e[5]):
                aged.append(e)
            else:
                flex.append(e)
        for e in aged:
            if e[6] > 0:
                # Previously deferred, now force-launched by age: the
                # starvation rule fired.
                self.aging_escapes += 1
                _WAVE_COUNTERS.bump("engine_wave_aging_escapes")
        # EWMA hold: a hot engine flushing a degenerate under-target wave
        # holds the WHOLE batch for the next kick instead — but never past
        # hold_max_s of the oldest entry's age, and never when an aged
        # entry must launch.
        if not aged and flex:
            rows = sum(len(e[0]) for e in flex)
            oldest = max(now - e[4] for e in flex)
            if rows < self._target_rows() and oldest < self.hold_max_s:
                self.held_flushes += 1
                _WAVE_COUNTERS.bump("engine_wave_held_flushes")
                return [], [e[:6] + (e[6] + 1,) for e in flex]
        kept = {id(e) for e in aged}
        kept_rows = sum(len(e[0]) for e in aged)
        kept_pages = sum(self._entry_pages(e) for e in aged)
        deferred_ids = set()
        for e in sorted(flex, key=lambda e: len(e[0])):
            r, p = len(e[0]), self._entry_pages(e)
            if kept_rows or kept_pages:
                t_new = 1 << (kept_rows + r - 1).bit_length()
                t_old = 1 << (kept_rows - 1).bit_length()
                p_new = 1 << (kept_pages + p - 1).bit_length()
                p_old = 1 << (kept_pages - 1).bit_length()
                bump_t = t_new > t_old and (
                    (t_new - (kept_rows + r)) / t_new > self.defer_pad_frac
                )
                bump_p = p_new > p_old and (
                    (p_new - (kept_pages + p)) / p_new > self.defer_pad_frac
                )
                if bump_t or bump_p:
                    deferred_ids.add(id(e))
                    continue
            kept.add(id(e))
            kept_rows += r
            kept_pages += p
        take, defer = [], []
        for e in batch:  # preserve arrival order on both sides
            if id(e) in deferred_ids:
                self.deferrals += 1
                _WAVE_COUNTERS.bump("engine_wave_deferrals")
                defer.append(e[:6] + (e[6] + 1,))
            else:
                take.append(e)
        return take, defer

    def _schedule_kick(self, deferred: List[tuple], now: float):
        """Guarantee a future flush for re-queued entries even if no new
        chunk ever arrives: a timed kick at (roughly) the earliest
        starvation deadline, clamped to the hold window."""
        if self._kick_handle is not None:
            return
        remaining = min(
            max(self._defer_bound_s(e[5]) - (now - e[4]), 0.0)
            for e in deferred
        )
        delay = max(min(remaining, self.hold_max_s), 0.0005)
        self._kick_handle = asyncio.get_running_loop().call_later(
            delay, self._kick
        )

    def _kick(self):
        self._kick_handle = None
        if self._pending and not self._flush_scheduled:
            self._flush_scheduled = True
            task = asyncio.ensure_future(self._flush())
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_tasks.discard)

    def _launch_graphed(self, t: int, t_real: int, host: tuple):
        """Launch one wave of rung ``t`` as that rung's CUDA graph (class
        docstring), capturing it first if the rung has none; ``host`` is
        the wave's int32 metadata on the host, in ``verify_step_ragged``'s
        order. The caller holds the exclusive gate. Returns (the wave's
        ``t_real`` logits rows, ``"replay"`` or ``"capture"``, the device
        counters and the expert choices, or None)."""
        h = self.h
        identity = _wave_identity(h.params, h.caches)
        if identity != self._graph_identity:
            self._graphs.clear()  # they point at the replaced tensors
            self._graph_identity = identity
        g = self._graphs.get(t)
        if g is not None:
            if g.copied is not None:
                g.copied.synchronize()  # the last wave's copy out of staging ran
            _int32_on(g.inputs.device, *host, out=(g.staging, g.inputs))
            if g.copied is not None:
                g.copied.record()
            g.graph.replay()
            for name, n in g.launches.items():
                _ext.LAUNCHES[name] += n
            self.graph_replays += 1
            return g.logits[:t_real].clone(), "replay", g.counts, g.choices
        device = h.params["embed"].device
        stream = self._graph_stream
        n = sum(np.size(a) for a in host)
        inputs = torch.empty(n, dtype=torch.int32, device=device)
        staging = torch.empty(n, dtype=torch.int32, pin_memory=stream is not None)
        copied = torch.cuda.Event() if stream is not None else None
        args = _int32_on(device, *host, out=(staging, inputs))
        if copied is not None:
            copied.record()
        counts_out = (torch.zeros(4, dtype=torch.int64, device=device) if self.counting
                      else None)
        choices_out = []  # the capture's [rows, layers, k] buffer, with a RoutingLog

        def run():
            # The module's name, looked up at each call (tests replace it).
            if counts_out is None:
                return verify_step_ragged(h.params, *args[:6], h.caches, args[6], h.config,
                                          h.max_req_blocks)[0]
            counts = LaunchCounts(choices=self.routing)
            logits = verify_step_ragged(h.params, *args[:6], h.caches, args[6], h.config,
                                        h.max_req_blocks, counts=counts)[0]
            counts_out.copy_(counts.total())
            if self.routing:
                rows = counts.choice_rows()
                if not choices_out:
                    choices_out.append(torch.empty_like(rows))
                choices_out[0].copy_(rows)
            return logits

        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream) if stream is not None else nullcontext():
            logits = run()  # serves this wave, and warms the capture stream up
            counted = dict(_ext.LAUNCHES)
            graph, out = self.capture(run, stream, self._graph_pool)
        launches = {k: n - counted[k] for k, n in _ext.LAUNCHES.items() if n != counted[k]}
        _ext.LAUNCHES.update(counted)  # a capture launches nothing
        if stream is not None:
            current = torch.cuda.current_stream(device)
            current.wait_stream(stream)
            logits.record_stream(current)
        choices = choices_out[0] if choices_out else None
        self._graphs[t] = WaveGraph(inputs, staging, copied, graph, out, launches,
                                    _ext.workspace_tensors(device), counts_out, choices)
        self.graph_captures += 1
        return logits[:t_real], "capture", counts_out, choices

    async def _flush(self):
        """One wave. Traced, a ``model.wave`` root span: ``take`` when the
        batch is taken, ``acquire`` when the gate is granted, ``launched``
        when the model call (or its graph's replay) returned on the host;
        attrs ``rows``, ``tokens``, ``t_bucket``, ``pages``, ``graph``
        (``replay``, ``capture`` or ``eager``) and, per row, its request's
        trace id (``requests``) and its ``step_chunk`` enqueue stamp
        (``enqueued_us``); for a model with device counters, the wave's
        (``LaunchCounts.FIELDS``), added once a request's token copy has
        brought them (``DeviceCounts``)."""
        batch: List[tuple] = []
        wave = None
        try:
            # Yield twice: once so sibling coroutines already unblocked this
            # tick can enqueue, once more for requests their completions wake.
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            batch, self._pending = self._pending, []
            # New arrivals after this point start the next wave.
            self._flush_scheduled = False
            if not batch:
                return
            if self.skew_policy:
                now = time.perf_counter()
                batch, deferred = self._partition(batch, now)
                if deferred:
                    # Front of the queue: deferred entries are older than
                    # anything arriving after the take, and the kick
                    # guarantees a re-flush even with no new arrivals.
                    self._pending[:0] = deferred
                    self._schedule_kick(deferred, now)
                if not batch:
                    return
                for e in batch:
                    if e[6] > 0:
                        age_us = (now - e[4]) * 1e6
                        self.defer_ages_us.append(age_us)
                        _WAVE_COUNTERS.note_defer_age(age_us)
            wave = tracing.start_span("model.wave", root=True)
            if wave is not None:
                wave.stage("take")
            # Ragged assembly (class docstring): concatenate the chunks
            # into one flat token list; pad only at the tail to the
            # power-of-two row bucket by repeating the last flat row
            # (same-bytes scatter, cache-safe); only real rows' futures
            # resolve.
            flat_toks: List[int] = []
            flat_pos: List[int] = []
            row_of: List[int] = []
            for r, (toks, pos, _tbl, _fut, *_) in enumerate(batch):
                flat_toks.extend(toks)
                flat_pos.extend(pos)
                row_of.extend([r] * len(toks))
            t_real = len(flat_toks)
            t_bucket = 1 << (t_real - 1).bit_length()
            flat_toks.extend([flat_toks[-1]] * (t_bucket - t_real))
            flat_pos.extend([flat_pos[-1]] * (t_bucket - t_real))
            row_of.extend([row_of[-1]] * (t_bucket - t_real))
            # Table rows pad to a power-of-two B: no flat token references
            # a padded row, so it neither scatters nor attends. Tables
            # arrive host-resident (_padded_table) — converting a DEVICE
            # array here would pay a blocking sync per request per wave.
            # Policy on: canonical bucket ladder (class docstring) — B
            # pads to the flat-row rung and pages to the rung maximum,
            # so the launch lands on (T, T, T * max_req_blocks), the one
            # declared bucket per rung that prewarm_wave_buckets
            # ran at startup. Both pads are compute-free; t_bucket
            # >= one flat row per entry >= len(batch) always covers.
            # A wave that replays a CUDA graph takes the same bucket, the
            # one shape its rung was captured at.
            graphed = self.capture is not None and t_bucket <= GRAPH_MAX_ROWS
            if self.skew_policy or graphed:
                b_bucket = t_bucket
                pad_pages = t_bucket * self.h.max_req_blocks
            else:
                b_bucket = 1 << (len(batch) - 1).bit_length()
                pad_pages = 0
            tables = [np.asarray(b[2], dtype=np.int32) for b in batch]
            tables.extend([tables[-1]] * (b_bucket - len(batch)))
            # build_ragged_wave picks the page bucket (pad_to_pow2, or the
            # canonical pad_to): the per-row page-count rule lives in
            # build_ragged_wave alone.
            meta = build_ragged_wave(
                [tables[r] for r in row_of],
                [p + 1 for p in flat_pos],
                self.h.config.block_tokens,
                pad_to=pad_pages,
                pad_to_pow2=True,
            )
            self.bucket_sizes.add((b_bucket, t_bucket, meta.num_pages))
            self.pad_rows += t_bucket - t_real
            self.launched_rows += t_bucket
            if self.skew_policy:
                _WAVE_COUNTERS.bump("engine_wave_policy_waves")
                _WAVE_COUNTERS.note_wave(t_real, t_bucket)
            if wave is not None:
                rows = [self._row_trace.pop(b[3], (0, 0)) for b in batch]
                wave.annotate(rows=len(batch), tokens=t_real, t_bucket=t_bucket,
                              pages=meta.num_pages,
                              requests=[r[0] for r in rows],
                              enqueued_us=[r[1] for r in rows])

            host = (flat_toks, flat_pos, row_of, meta.pages, meta.page_rows,
                    meta.page_starts, np.stack(tables))
            if not graphed:
                # The wave's int32 metadata travels to the device in ONE copy.
                block = tracing.start_span("loop.block", parent=wave)
                dev_args = _int32_on(self.h.params["embed"].device, *host)
                if block is not None:
                    block.annotate(what="h2d")
                    block.finish()
            async with self.h.gate.exclusive(kind="wave", parent=wave):
                if wave is not None:
                    wave.stage("acquire")
                if graphed:
                    # Under the gate: the rung's static inputs are shared
                    # by every wave of that rung.
                    logits, how, counts, choices = self._launch_graphed(t_bucket, t_real, host)
                else:
                    # Only a counting model's call takes ``counts`` (tests
                    # replace the function with ones that take none).
                    launch = ({"counts": LaunchCounts(choices=self.routing)} if self.counting
                              else {})
                    logits, self.h.caches = verify_step_ragged(
                        self.h.params, *dev_args[:6], self.h.caches, dev_args[6],
                        self.h.config, self.h.max_req_blocks, **launch,
                    )
                    counts = launch["counts"].total() if launch else None
                    choices = launch["counts"].choice_rows() if self.routing else None
                    how = "eager"
                    self.eager_waves += 1
                if counts is not None:
                    slot, held = self._counts_to_host(counts, choices)
                    first = 0
                    for toks, _, _, fut, *_ in batch:
                        self._fut_counts[fut] = (slot, len(toks) / t_real, wave, held, first)
                        first += len(toks)
                if wave is not None:
                    wave.stage("launched")
            if wave is not None:
                wave.annotate(graph=how)
                wave.finish()
            self.waves += 1
            self.max_wave = max(self.max_wave, len(batch))
            off = 0
            for toks, _, _, fut, *_ in batch:
                if not fut.done():
                    fut.set_result(logits[off : off + len(toks)])
                off += len(toks)
        except BaseException as e:  # noqa: BLE001 - must fail the waiters
            # A dead flush (model error, or cancellation/GC at shutdown)
            # must strand NO waiter: fail the taken batch and anything still
            # pending, and clear the flag so a later step() starts fresh.
            self._flush_scheduled = False
            stranded, self._pending = batch + self._pending, []
            if wave is not None:
                wave.finish(status=f"error:{type(e).__name__}")
            for entry in stranded:
                self._row_trace.pop(entry[3], None)
            exc = e if isinstance(e, Exception) else RuntimeError(
                f"decode wave aborted: {e!r}"
            )
            for _, _, _, fut, *_ in stranded:
                if not fut.done():
                    fut.set_exception(exc)
            if not isinstance(e, Exception):
                raise


class NGramDrafter:
    """Prompt-lookup drafting: propose the tokens that FOLLOWED the most
    recent earlier occurrence of the request's current suffix n-gram in its
    own history (prompt + generated so far). Free speculation — no draft
    model, no device work — that wins exactly where serving workloads
    repeat themselves (quoting the prompt, code identifiers, templated
    text), and greedy verification makes output token-for-token identical
    to plain decode regardless of draft quality (tested). The same
    self-drafting idea as published prompt-lookup / LLMA decoding.
    """

    def __init__(self, max_draft: int = 7, ngram: int = 2):
        if max_draft < 1 or ngram < 1:
            raise ValueError("max_draft and ngram must be >= 1")
        self.max_draft = max_draft
        self.ngram = ngram

    def draft(self, history: Sequence[int]) -> List[int]:
        """Up to ``max_draft`` proposed continuations of ``history`` (empty
        when no suffix n-gram recurs — the caller then runs a plain decode
        step). Longest n first: a longer matched context drafts better."""
        h = list(history)
        for n in range(min(self.ngram, len(h) - 1), 0, -1):
            pattern = h[-n:]
            # Most recent earlier occurrence: scan right to left, excluding
            # the suffix occurrence itself (i + n <= len(h) - 1, so the
            # continuation is never empty).
            for i in range(len(h) - n - 1, -1, -1):
                if h[i : i + n] == pattern:
                    return h[i + n : i + n + self.max_draft]
        return []


class EngineKVAdapter:
    """vLLM-style connector surface over ``KVConnector`` (engine terms:
    token counts in, engine-owned physical block tables in, caches out)."""

    # This adapter can forward the two-class QoS tag (wire.PRIORITY_*) on
    # start_fetch; the harness gates tagging on the attribute so duck-typed
    # adapter stand-ins without the kwarg keep working.
    QOS_AWARE = True

    def __init__(self, connector):
        self.connector = connector
        self.block_tokens = connector.spec.block_tokens

    def get_num_matched_tokens(self, token_ids: Sequence[int]) -> int:
        """Admission-time probe: how many leading TOKENS of this prompt the
        store already holds (block-aligned; one control round trip)."""
        return self.connector.lookup(token_ids) * self.block_tokens

    def tier_location(self, token_ids) -> Optional[str]:
        """Which tier would serve this prompt right now — ``"hot"`` /
        ``"cold"`` / ``None`` — from the connector's catalog knowledge
        (``ClusterKVConnector.tier_location``, docs/tiering.md); ``None``
        for connectors without a tiered pool. Network-free: the harness
        consults this at admission to pick the staged two-phase path vs
        the direct one-phase load for a cold-only root."""
        fn = getattr(self.connector, "tier_location", None)
        return fn(token_ids) if fn is not None else None

    def note_tier_direct(self):
        """The harness skipped the staged prefetch for a cold-only root:
        count it in the connector's tier ledger too, so /metrics
        ``infinistore_tier_direct_reads`` reflects engine flows (the
        harness-local ``tier_direct_loads`` metric counts the same
        events engine-side)."""
        tiering = getattr(self.connector, "tiering", None)
        if tiering is not None:
            tiering.note_direct_read()

    def start_fetch(
        self, token_ids, limit_blocks: Optional[int] = None, priority: int = 0
    ):
        """Speculative, gate-free half of a load: probe + start streaming
        the hit prefix into host staging NOW (before the engine has even
        allocated blocks). Returns a prefetch handle (``hit_blocks``,
        ``install``, ``discard`` — KVConnector.start_fetch), or None when
        the underlying connector has no two-phase path (the caller then
        uses the one-phase ``load_kv``). StagingPoolExhausted propagates —
        it is admission backpressure, not failure.

        ``priority``: QoS class for the fetch's store reads
        (wire.PRIORITY_*) — the harness tags a prefetch BACKGROUND when
        the request cannot make the next wave anyway (docs/qos.md). The
        kwarg is forwarded only when nonzero and the connector advertises
        ``QOS_AWARE`` — a pre-QoS duck-typed connector keeps its old
        signature and the tag is dropped, never TypeError'd (the
        wire.qos_kwargs convention)."""
        if not hasattr(self.connector, "start_fetch"):
            return None
        kw = (
            {"priority": priority}
            if priority and getattr(self.connector, "QOS_AWARE", False)
            else {}
        )
        # Audited: sync entry point — the probe RTT is the caller's
        # documented cost; loop callers use start_fetch_async.
        return self.connector.start_fetch(  # its: allow[ITS-L001]
            token_ids, limit_blocks=limit_blocks, **kw
        )

    async def start_fetch_async(
        self, token_ids, limit_blocks: Optional[int] = None, priority: int = 0
    ):
        """``start_fetch`` for event-loop callers: routes to the
        connector's :meth:`~.connector.KVConnector.start_fetch_async`
        (probe RTT in an executor) when it has one; a sync-only
        duck-typed connector falls back to the inline probe, same as
        before this method existed."""
        sf_async = getattr(self.connector, "start_fetch_async", None)
        if sf_async is None:
            return self.start_fetch(
                token_ids, limit_blocks=limit_blocks, priority=priority
            )
        kw = (
            {"priority": priority}
            if priority and getattr(self.connector, "QOS_AWARE", False)
            else {}
        )
        return await sf_async(token_ids, limit_blocks=limit_blocks, **kw)

    async def install_kv(self, prefetch, caches, block_table: np.ndarray):
        """The short exclusive half: scatter a prefetch's staged layers
        into the engine's cache blocks. Same contract as ``load_kv``
        (in place; returns (caches, tokens_loaded))."""
        out, blocks = await prefetch.install(caches, block_table)
        return out, blocks * self.block_tokens

    async def load_kv(self, token_ids, caches, block_table: np.ndarray):
        """Fetch the cached prefix into the engine's cache blocks. Returns
        (updated caches, tokens_loaded). Input caches are consumed
        (written in place) — use the returned ones."""
        out, blocks = await self.connector.load(token_ids, caches, block_table)
        return out, blocks * self.block_tokens

    async def save_kv(
        self, token_ids, caches, block_table: np.ndarray, first_block: int = 0
    ) -> int:
        """Stream this request's computed KV blocks to the store (layer by
        layer, D2H overlapping the network). ``first_block``: logical index
        of block_table[0] within the prompt — pass the prefix-hit count to
        save only the computed suffix (the loaded prefix is already stored)."""
        return await self.connector.save(
            token_ids, caches, block_table, first_block=first_block
        )

    def evict_request(self, token_ids) -> int:
        """Drop a request's blocks from the store (engine-initiated)."""
        return self.connector.drop(token_ids)


@dataclass
class RequestStats:
    """Per-request outcome, engine-side."""

    tokens: int
    hit_blocks: int  # lookup()'s admission answer
    loaded_blocks: int  # what load actually delivered (== hit unless raced)
    computed_blocks: int
    admission_us: float  # t0 -> prefix load settled (the scheduler stall)
    raced_eviction: bool  # lookup hit but blocks evicted before the read
    verified: Optional[bool]  # None when verification is off
    generated: Optional[List[int]] = None  # wave-decoded tokens (greedy)
    # Decomposition of admission_us: what the STORE cost (admission lookup
    # + the load pipeline: fetch/H2D/scatter) vs what was spent WAITING for
    # the exclusive device gate behind other requests' loads and computes.
    # The two do not sum to admission_us (event-loop scheduling and future
    # plumbing fill the gap) but each is individually honest — a fat
    # gate_stall with a thin store_io means the engine is compute-bound,
    # not store-bound. gate_stall_us totals EVERY exclusive-gate wait the
    # request paid (install at admission, then the compute phase), so
    # misses — which no longer touch the gate at admission — still report
    # their queue time.
    store_io_us: float = 0.0
    gate_stall_us: float = 0.0
    # Two-phase admission (prefetch path): how long the exclusive gate was
    # actually HELD for the install (host->device scatter — the only part
    # of a load that still needs exclusivity), the gate-free store fetch's
    # duration, and what fraction of that fetch ran while this request
    # held NO gate (1.0 = store I/O fully hidden behind other work).
    gate_hold_us: float = 0.0
    fetch_us: float = 0.0
    overlap_fraction: Optional[float] = None
    # Prefetch accounting: K+V blocks staged for this request, and how
    # many of those never reached the device (discarded on raced
    # eviction / cancellation — the waste the speculation paid).
    prefetched_blocks: int = 0
    wasted_blocks: int = 0
    # t0 -> the request's ENTIRE prefix resident on device (loaded and/or
    # computed): the end-to-end figure that decides whether a cache hit
    # actually beats recomputing.
    prefix_ready_us: float = 0.0
    # t0 -> the FIRST generated token on the host, after its round's
    # device-to-host copy returned (0.0 when gen_tokens == 0): the
    # serving-side latency figure the skew-aware flush policy is graded on
    # (docs/serving_load.md), and the request's QoS class
    # (wire.PRIORITY_*) so TTFT percentiles split by class.
    ttft_us: float = 0.0
    priority: int = 0
    # Device counters (models/llama.py LaunchCounts) of the launches that
    # computed this request, for a model that has them: the (layer, expert)
    # weight sets read, the (token, expert) pairs computed, the most rows
    # one expert took in a launch, and the keys sliding windows skipped; a
    # wave's shared over its live rows. ``device_counts``: per launch,
    # (host time on perf_counter when the counts reached the host, reads,
    # pairs, most rows, keys skipped).
    moe_expert_reads: float = 0.0
    moe_token_pairs: float = 0.0
    moe_max_expert_rows: int = 0
    window_keys_skipped: float = 0.0
    device_counts: List[tuple] = field(default_factory=list)


class ContinuousBatchingHarness:
    """Drive N concurrent requests through the adapter against one shared
    paged cache — the BASELINE config-4 workload shape (vLLM paged-KV via an
    LMCache-style connector), minus the real engine.

    Drive one harness instance from ONE event loop: its asyncio primitives
    (pool/gate conditions, wave futures) bind to the loop that first awaits
    them, so spreading requests across several ``asyncio.run`` calls raises
    "bound to a different event loop" once anything actually blocks.

    ``verify=True`` recomputes every request with a fresh one-shot prefill
    (the model's own oracle) and compares the harness cache's blocks —
    catching any stale/corrupt bytes a load under eviction churn could have
    delivered. Decode-computed suffixes match the prefill oracle to float
    tolerance (same bound the model tests use); store-loaded prefixes are
    byte-identical by the data plane's contract.
    """

    def __init__(
        self,
        adapter: EngineKVAdapter,
        params,
        config,
        num_blocks: int,
        max_req_blocks: int,
        verify: bool = False,
        verify_tol: float = 2e-4,
        drafter: Optional[NGramDrafter] = None,
        wave_skew_policy: bool = False,
        wave_defer_max_s: float = 0.025,
        wave_defer_max_bg_s: Optional[float] = None,
        wave_defer_pad_frac: float = 0.25,
        wave_hold_max_s: float = 0.002,
        device="cuda",
    ):
        """``drafter``: enables speculative decoding in the serving loop —
        each generation round verifies the drafted chunk in one wave row
        (verify_step_ragged), emitting every greedy-accepted token plus
        the model's continuation, so tokens/round can exceed 1 with output
        identical to plain greedy decode.

        ``wave_skew_policy`` + the ``wave_defer_*`` / ``wave_hold_max_s``
        knobs: the WaveDecoder's skew-aware deferral flush policy
        (docs/serving_load.md). Off by default — the False path is
        behavior-identical to the blind first-arrival flush (tested).

        ``device``: where the shared cache is made (default ``"cuda"``;
        raises without a card); ``params`` must live there."""
        self.device = _ext.resolve_device(device)
        self.adapter = adapter
        self.params = params
        self.config = config
        self.drafter = drafter
        self.spec_rounds = 0  # generation waves a request participated in
        self.spec_drafted = 0  # draft tokens proposed
        self.spec_accepted = 0  # draft tokens accepted
        self.caches = config.kv_spec(num_blocks).make_caches(device=self.device)
        self.pool = BlockPool(num_blocks)
        self.gate = DeviceGate()
        self.wave = WaveDecoder(
            self,
            skew_policy=wave_skew_policy,
            defer_max_s=wave_defer_max_s,
            defer_max_bg_s=wave_defer_max_bg_s,
            defer_pad_frac=wave_defer_pad_frac,
            hold_max_s=wave_hold_max_s,
        )
        self.max_req_blocks = max_req_blocks
        self.verify = verify
        # float-exact stores hold 2e-4 in f32; a bf16 model or a quantizing
        # adapter (int8 blocks) needs its own tolerance.
        self.verify_tol = verify_tol
        # Instrumentation the test pins: request-level concurrency and
        # overlapping store writes.
        self.live = 0
        self.max_live = 0
        self._saving = 0
        self.max_concurrent_saves = 0
        # Admissions that wanted a prefetch but found the staging arena
        # full and fell back to the one-phase gated load (backpressure).
        self.prefetch_fallbacks = 0
        # Admissions whose root was COLD-ONLY (tiered capacity plane,
        # docs/tiering.md): the staged prefetch was skipped on purpose and
        # the one-phase load read the root directly from the cold pool.
        self.tier_direct_loads = 0
        # Prefetch bytes from requests that DIED before install (cancelled
        # mid-admission): they never reach self.stats, but their waste is
        # real and must show in prefetch_waste.
        self._prefetch_extra_fetched = 0
        self._prefetch_extra_wasted = 0
        self.stats: List[RequestStats] = []
        self._prefill_per_block_s: Optional[float] = None
        # A prefill's or resume's device counters come back here, behind
        # the model call's own sync (the exclusive gate serialises them).
        self._model_counts = (torch.zeros(4, dtype=torch.int64,
                                          pin_memory=self.device.type == "cuda")
                              if self.wave.counting else None)
        self.routing_log = getattr(config, "routing_log", None) if self.wave.routing else None

    # -- model compute -------------------------------------------------------

    async def prewarm_wave_buckets(self, max_rows: int = 64) -> list:
        """Run the skew policy's declared wave-bucket ladder once.

        With ``wave_skew_policy`` on, every wave launches on the
        canonical ``(T, T, T * max_req_blocks)`` bucket (WaveDecoder
        docstring), so the launch shapes are KNOWN AT STARTUP: one
        bucket per power-of-two row rung up to ``max_rows``. This runs
        one throwaway wave per rung — the real ``verify_step_ragged``
        call, zero tokens at position 0. The port compiles nothing per
        shape (the kernels are built once), so what this warms is the
        first launch of each shape and the allocator; ``prewarmed``
        keeps the reference's meaning: the declared ladder. The dummy scatter rides block
        0 slot 0, harmless under the cache invariant: a request only
        attends slots its own prefill/decode populated. No-op
        (returns ``[]``) with the policy off — a blind flush has no
        declared shape set, which is exactly why it keeps compiling
        mid-serving. Returns the prewarmed ladder."""
        if not self.wave.skew_policy:
            return []
        mrb = self.max_req_blocks
        ladder = []
        t = 1
        while t <= max_rows:
            meta = build_ragged_wave(
                [np.zeros(mrb, dtype=np.int32)] * t,
                [1] * t,
                self.config.block_tokens,
                pad_to=t * mrb,
            )
            zeros_t = np.zeros((t,), np.int32)
            async with self.gate.exclusive(kind="wave"):
                _, self.caches = verify_step_ragged(
                    self.params,
                    zeros_t,
                    zeros_t,
                    zeros_t,
                    meta.pages,
                    meta.page_rows,
                    meta.page_starts,
                    self.caches,
                    np.zeros((t, mrb), np.int32),
                    self.config,
                    mrb,
                )
            bucket = (t, t, t * mrb)
            self.wave.prewarmed.add(bucket)
            ladder.append(bucket)
            t <<= 1
        return ladder

    def _padded_table(self, table: np.ndarray) -> np.ndarray:
        """Host-resident padded table. Numpy ON PURPOSE: the WaveDecoder
        re-reads it every flush to assemble ragged metadata, and a device
        tensor there would cost a blocking device->host sync per request
        per wave."""
        pad = np.zeros(self.max_req_blocks, dtype=np.int32)
        pad[: len(table)] = table
        return pad

    def _launch_counts(self) -> Optional[LaunchCounts]:
        if self._model_counts is None:
            return None
        return LaunchCounts(choices=self.routing_log is not None)

    def _queue_counts(self, counts: Optional[LaunchCounts]):
        """Queue a model call's counters' copy (and, with a RoutingLog, its
        expert choices') before its sync; after the sync ``_model_counts``
        and the returned tensor hold them."""
        if counts is None:
            return None
        self._model_counts.copy_(counts.total(), non_blocking=True)
        if self.routing_log is None:
            return None
        rows = counts.choice_rows()
        held = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=self.device.type == "cuda")
        held.copy_(rows, non_blocking=True)
        return held

    def _read_counts(self, counts: Optional[LaunchCounts], held, token_ids,
                     start: int) -> Optional[tuple]:
        """The call's counters on the host, after its sync; its choices go to
        the RoutingLog as those of rows ``start ..`` of ``token_ids``."""
        if counts is None:
            return None
        if held is not None:
            # A copy: the pinned buffer goes back to the host allocator.
            self.routing_log.put(token_ids, start, held.numpy().copy())
        return tuple(self._model_counts.tolist())

    def _prefill_full(self, token_ids, table: np.ndarray):
        """Whole-prompt prefill into this request's blocks (cache-mutating:
        caller holds the exclusive gate). Returns its device counters
        (host values) or None."""
        t0 = time.perf_counter()
        counts = self._launch_counts()
        _, self.caches = prefill(
            self.params,
            token_ids,
            self.caches,
            table,
            self.config,
            counts=counts,
        )
        held = self._queue_counts(counts)
        self._sync()
        # Calibrates recompute_saved_s: what one block of prefill costs
        # on this device. Min across calls — the first includes one-time
        # warm-up, which a steady-state engine never pays per request.
        per_block = (time.perf_counter() - t0) / len(table)
        if self._prefill_per_block_s is None or per_block < self._prefill_per_block_s:
            self._prefill_per_block_s = per_block
        return self._read_counts(counts, held, token_ids, 0)

    def _chunked_resume(self, token_ids, table: np.ndarray, start_block: int):
        """Compute the suffix after a prefix hit as ONE chunked continuation
        (models/llama.py prefill_continue — the engine's chunked-prefill
        resume path): every suffix row attends its own prefix in a single
        batched kernel launch per layer, with chunk-wide GEMMs, instead of
        S_c sequential decode launches. Cache-mutating: caller holds the
        exclusive gate. Returns its device counters (host values) or None."""
        bt = self.config.block_tokens
        counts = self._launch_counts()
        _, self.caches = prefill_continue(
            self.params,
            token_ids[start_block * bt :],
            start_block * bt,
            self.caches,
            self._padded_table(table),
            self.config,
            self.max_req_blocks,
            counts=counts,
        )
        held = self._queue_counts(counts)
        self._sync()
        return self._read_counts(counts, held, token_ids, start_block * bt)

    def _sync(self):
        """Wait for the work this thread queued on the card (no-op on the
        CPU): executor-thread compute and snapshots must be finished before
        the gate is released or the writer's side-stream copy starts."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    async def _save_blocks(self, chain_ids, phys_blocks, first_block: int,
                           path: str):
        """Snapshot the given physical blocks into private arrays under the
        shared gate (device-side gathers, microseconds), then stream them to
        the store with NO gate held: the save — the long store-I/O phase —
        overlaps other requests' loads, computes, and saves. Holding the
        gate across the save would serialize the whole pipeline (the next
        request's exclusive load waits on it). ``chain_ids`` key the blocks
        (the prompt, or prompt + generated for response blocks).

        Traced, an ``engine.save`` span (attrs ``path``: ``ttft`` for the
        prompt's suffix, saved before the first token, ``response`` for the
        answer's blocks; ``blocks``, ``bytes``) is the active span for the
        snapshot's gate and the writer's store calls."""
        span = tracing.start_span("engine.save")
        token = tracing.bind_span(span)
        try:
            if span is not None:
                k0 = self.caches[0][0]
                span.annotate(path=path, blocks=len(phys_blocks),
                              bytes=2 * len(self.caches) * len(phys_blocks)
                              * k0[0].numel() * k0.element_size())
            block = tracing.start_span("loop.block")
            dev = torch.as_tensor(
                np.asarray(phys_blocks), dtype=torch.int32, device=self.device
            )
            if block is not None:
                block.annotate(what="h2d")
                block.finish()
            async with self.gate.shared(kind="snapshot"):
                caches = self.caches  # stable under the shared gate

                def snap():
                    # Every layer's K and V blocks in one gather (one K1 launch),
                    # handed on as per-(layer, kind) views of the packed result.
                    n = len(phys_blocks)
                    flat = gather_blocks_many([t for kv in caches for t in kv], dev)
                    self._sync()
                    return [(flat[2 * i * n : (2 * i + 1) * n],
                             flat[(2 * i + 1) * n : (2 * i + 2) * n])
                            for i in range(len(caches))]

                # Executor: the gathers + readiness wait must not pin the event
                # loop (it is the artery every gate-free fetch completion and
                # wave flush flows through).
                snapshot = await asyncio.get_running_loop().run_in_executor(None, snap)
            self._saving += 1
            self.max_concurrent_saves = max(self.max_concurrent_saves, self._saving)
            try:
                await self.adapter.save_kv(
                    chain_ids,
                    snapshot,
                    np.arange(len(phys_blocks), dtype=np.int32),
                    first_block=first_block,
                )
            finally:
                self._saving -= 1
        except BaseException as e:
            if span is not None:
                span.finish(status=f"error:{type(e).__name__}")
            raise
        finally:
            tracing.unbind_span(token)
            if span is not None:
                span.finish()

    async def _generate(
        self, token_ids, table: np.ndarray, gen_tokens: int, priority: int = 0
    ):
        """Greedy generation through the shared WaveDecoder: every live
        request advances one round per lockstep wave (the continuous-
        batching inner loop). The first round re-decodes the last prompt
        token — its K/V insert rewrites identical bytes (the decode ==
        prefill invariant) and yields the logits that choose token one.

        With a ``drafter``, each round's wave row is a CHUNK: the committed
        token plus drafted continuations, verified in one pass (row j's
        argmax follows chunk[:j+1], so chunk[j+1] is accepted iff it equals
        that argmax — the speculative_verify recurrence, models/llama.py).
        Every accepted token plus the model's own continuation is emitted:
        tokens/round > 1 whenever drafts land, and rejected rows cost
        nothing (their K/V is masked by position until real tokens
        overwrite it). The chunk is capped to the tokens still wanted, so
        a round never overshoots ``gen_tokens``.

        Returns ``(tokens, first_token_t)`` — the perf_counter stamp of
        the first emitted token, taken once it is on the host (after the
        round's device-to-host copy), feeds ``RequestStats.ttft_us``.
        Traced, the request's span gets a ``token`` stamp for each emitted
        token at the same moment, and the copy is a ``loop.block`` span
        (``what`` ``token``)."""
        rspan = tracing.active_span()
        padded = self._padded_table(table)
        pos = len(token_ids) - 1
        tok = int(token_ids[-1])
        history = list(token_ids)
        sink = _DEVICE_COUNTS.get()
        # Where each step's rows lie in ``history``, for the RoutingLog.
        routing = self.routing_log is not None and sink is not None
        out: List[int] = []
        first_token_t: Optional[float] = None
        while len(out) < gen_tokens:
            chunk = [tok]
            if self.drafter is not None:
                remaining = gen_tokens - len(out)
                chunk += self.drafter.draft(history)[: remaining - 1]
            if routing:
                sink.rows = (history, pos, chunk)
            rows = await self.wave.step_chunk(
                chunk, list(range(pos, pos + len(chunk))), padded,
                priority=priority,
            )
            block = tracing.start_span("loop.block")
            # ONE device->host transfer per round (the [K] argmaxes).
            preds = torch.argmax(rows, dim=-1).cpu().numpy()
            if sink is not None and sink.pending:
                sink.settle(time.perf_counter())  # the copy above waited for its slot
            t_us = None
            if first_token_t is None:
                first_token_t = time.perf_counter()
                if rspan is not None:
                    t_us = tracing.us_of_perf(first_token_t)
            if block is not None:
                block.annotate(what="token")
                block.finish()
            n_acc = 1
            while n_acc < len(chunk) and chunk[n_acc] == int(preds[n_acc - 1]):
                n_acc += 1
            emitted = chunk[1:n_acc] + [int(preds[n_acc - 1])]
            if rspan is not None:
                if t_us is None:
                    t_us = tracing.now_us()
                for _ in emitted:
                    rspan.stage("token", t_us)
            out.extend(emitted)
            history.extend(emitted)
            self.spec_rounds += 1
            self.spec_drafted += len(chunk) - 1
            self.spec_accepted += n_acc - 1
            pos += n_acc
            tok = emitted[-1]
        # Each round inserts its CHUNK's K/V; the final emitted token's
        # insert only happens as the next round's committed token. When it
        # completes a block (which the extended-chain save below persists),
        # one more step lands it; otherwise its block is an incomplete tail
        # with no chain key — skip the wasted wave.
        if (len(token_ids) + gen_tokens) % self.config.block_tokens == 0:
            if routing:
                sink.rows = (history, pos, [tok])
            await self.wave.step(tok, pos, padded, priority=priority)
        return out, first_token_t

    def _verify_request(self, token_ids, table: np.ndarray) -> bool:
        """Compare the harness cache's blocks for this request against a
        fresh one-shot prefill oracle (gather-only on the shared cache)."""
        n = len(table)
        oracle_caches = self.config.kv_spec(n).make_caches(device=self.device)
        _, oracle_caches = prefill(
            self.params,
            token_ids,
            oracle_caches,
            np.arange(n, dtype=np.int32),
            self.config,
        )
        ids = torch.as_tensor(np.asarray(table), dtype=torch.int32, device=self.device)
        for layer in range(len(self.caches)):
            for kind in (0, 1):
                got = gather_blocks(self.caches[layer][kind], ids).float()
                want = oracle_caches[layer][kind].float()
                if not torch.allclose(
                    got, want, rtol=self.verify_tol, atol=self.verify_tol
                ):
                    return False
        return True

    # -- request lifecycle ---------------------------------------------------

    async def run_request(
        self,
        token_ids: Sequence[int],
        gen_tokens: int = 0,
        priority: int = 0,
    ) -> RequestStats:
        """``priority``: the request's QoS class (wire.PRIORITY_*).
        BACKGROUND requests tag their speculative store prefetch
        background and tolerate a longer wave-deferral age under the
        skew-aware flush policy (docs/serving_load.md); the class is
        recorded on the stats so TTFT percentiles split by class."""
        bt = self.config.block_tokens
        n_blocks = len(token_ids) // bt
        total_blocks = -(-(n_blocks * bt + gen_tokens) // bt)
        if n_blocks == 0 or total_blocks > self.max_req_blocks:
            raise ValueError(
                f"prompt + generation must span 1..{self.max_req_blocks} "
                "blocks (prompt in complete blocks)"
            )
        token_ids = list(token_ids)[: n_blocks * bt]
        self.live += 1
        self.max_live = max(self.max_live, self.live)
        # Trace root for this request (docs/observability.md): `enqueue` is
        # stamped at admission t0, `install` when fetched bytes land in the
        # paged cache; every store op issued below (prefetch -> coalescer ->
        # striped scheduler -> wire) becomes a child of this span via the
        # bound context. With tracing off this is three no-op calls.
        rspan = tracing.start_span("engine_request")
        rtoken = tracing.bind_span(rspan)
        device_counts = DeviceCounts(self.routing_log) if self.wave.counting else None
        ctoken = _DEVICE_COUNTS.set(device_counts)
        # Speculative prefetch AT ENQUEUE: probe + start streaming the hit
        # prefix into host staging before BlockPool.alloc even completes —
        # the store fetch overlaps this request's own admission wait and
        # every other request's compute, and NEVER holds the device gate.
        t0 = time.perf_counter()
        if rspan is not None:
            rspan.stage("enqueue", tracing.us_of_perf(t0))
            rspan.annotate(tokens=len(token_ids), blocks=n_blocks)
        fspan = None  # engine.fetch: start_fetch -> primed()
        prefetch = None
        prefetch_settled = True  # nothing to discard until a fetch starts
        fallback_hit: Optional[int] = None  # probe answer from a failed start_fetch
        table = None
        # One try for the whole admission (the speculative starter INCLUDED):
        # a probe that dies on a dead store must still release the live
        # count, unbind the trace context, and finish the request span —
        # otherwise the task's later ops parent under a zombie span.
        try:
            # getattr: adapters without a two-phase path (QuantizingKVAdapter)
            # simply keep the one-phase gated load below. Prefer the async
            # variant — it hops the probe RTT through an executor instead of
            # blocking this loop mid-wave (ITS-L001).
            starter = getattr(
                self.adapter, "start_fetch_async",
                getattr(self.adapter, "start_fetch", None),
            )
            # Tier consult (docs/tiering.md): a COLD-ONLY root skips the
            # staged speculative prefetch entirely — a slow pooled-cold
            # read must not reserve (and hold hostage) staging regions the
            # current wave's hot fetches need. The one-phase load below
            # reads it DIRECTLY from the cold member instead (the DAK
            # direct-access path). Network-free check (catalog knowledge).
            tier_fn = getattr(self.adapter, "tier_location", None)
            if starter is not None and tier_fn is not None:
                if tier_fn(token_ids) == "cold":
                    starter = None
                    self.tier_direct_loads += 1
                    note = getattr(self.adapter, "note_tier_direct", None)
                    if note is not None:
                        note()
            starter_is_async = asyncio.iscoroutinefunction(starter)
            if starter is not None:
                # QoS: a request the block pool cannot admit right now is
                # beyond the next wave — its speculative fetch is
                # opportunistic, so it rides BACKGROUND class and never
                # delays the current wave's decode-blocking reads. Requests
                # that can start immediately keep the FOREGROUND (untagged)
                # fetch. Only adapters that advertise the kwarg (QOS_AWARE)
                # are tagged.
                fetch_kw = {}
                if getattr(self.adapter, "QOS_AWARE", False) and (
                    self.pool.available < total_blocks
                    or priority == PRIORITY_BACKGROUND
                ):
                    fetch_kw["priority"] = PRIORITY_BACKGROUND
                # The fetch's store reads run in tasks that inherit the
                # context here, so they parent under engine.fetch.
                fspan = tracing.start_span("engine.fetch")
                ftoken = tracing.bind_span(fspan)
                try:
                    result = starter(token_ids, limit_blocks=n_blocks, **fetch_kw)
                    prefetch = await result if starter_is_async else result
                except StagingPoolExhausted as e:
                    # Admission backpressure: the staging arena is carrying a
                    # full wave already — this request takes the gated load,
                    # reusing the probe the failed start_fetch already paid.
                    self.prefetch_fallbacks += 1
                    fallback_hit = getattr(e, "hit_blocks", None)
                finally:
                    tracing.unbind_span(ftoken)
            lookup_s = time.perf_counter() - t0  # start_fetch includes the probe
            prefetch_settled = prefetch is None or prefetch.n_blocks == 0
            if fspan is not None and prefetch_settled:
                fspan.finish()  # nothing to stream: the fetch ends here
            table = await self.pool.alloc(total_blocks)
            if prefetch is not None:
                # Admitted: a background-tagged speculative fetch is
                # decode-blocking from here — upgrade its remaining
                # submissions to foreground (no-op when already untagged).
                promote = getattr(prefetch, "promote", None)
                if promote is not None:
                    promote()
            prompt_table = table[:n_blocks]  # tail blocks (if any) are for generation
            gate_hold_us = fetch_us = 0.0
            overlap = None
            if prefetch is not None:
                # -- pipelined admission: fetch (gate-free) then install --
                hit_tokens = prefetch.hit_blocks * bt
                loaded_tokens = 0
                gate_stall_us = store_io_us = 0.0
                if prefetch.n_blocks:
                    # Wait for the fetch pipeline to fill WITHOUT the gate:
                    # the store I/O runs while other requests compute.
                    await prefetch.primed()
                    if fspan is not None:
                        fspan.finish()
                    t_gate = time.perf_counter()
                    async with self.gate.exclusive(expedite=True, kind="install"):
                        gate_stall_us = (time.perf_counter() - t_gate) * 1e6
                        ispan = tracing.start_span("engine.install")
                        t_hold = time.perf_counter()
                        self.caches, loaded_tokens = await self.adapter.install_kv(
                            prefetch,
                            self.caches,
                            prompt_table[: prefetch.n_blocks],
                        )
                        if rspan is not None:
                            rspan.stage("install")
                        if ispan is not None:
                            # When the last layer the install waited for had
                            # landed in staging (start, if all had already).
                            landed = getattr(prefetch, "last_landed_us", None) or 0
                            ispan.stage("staged", max(landed, ispan.t0_us))
                            ispan.finish()
                        gate_hold_us = (time.perf_counter() - t_hold) * 1e6
                    prefetch_settled = True
                    t_end = prefetch.fetch_finished_s or time.perf_counter()
                    fetch_dur = max(t_end - prefetch.fetch_started_s, 0.0)
                    fetch_us = fetch_dur * 1e6
                    if fetch_dur > 0:
                        # Fraction of the fetch that ran before this request
                        # acquired the gate = store I/O hidden behind other
                        # work instead of serializing the device.
                        overlapped = min(t_end, t_gate) - prefetch.fetch_started_s
                        overlap = min(1.0, max(0.0, overlapped / fetch_dur))
                # The store's own cost: probe + gate-free fetch + the
                # install's H2D/scatter. Unlike the pre-split pipeline,
                # only the LAST term ever serializes the device.
                store_io_us = lookup_s * 1e6 + fetch_us + gate_hold_us
            else:
                # -- one-phase fallback (no start_fetch, or arena full) --
                if fallback_hit is not None:
                    hit_tokens = fallback_hit * bt
                else:
                    t_l = time.perf_counter()
                    hit_tokens = self.adapter.get_num_matched_tokens(token_ids)
                    lookup_s = time.perf_counter() - t_l
                t_gate = time.perf_counter()
                async with self.gate.exclusive(kind="load"):
                    gate_stall_us = (time.perf_counter() - t_gate) * 1e6
                    t_io = time.perf_counter()
                    self.caches, loaded_tokens = await self.adapter.load_kv(
                        token_ids, self.caches, prompt_table
                    )
                    if rspan is not None and loaded_tokens:
                        rspan.stage("install")
                    gate_hold_us = (time.perf_counter() - t_io) * 1e6
                    store_io_us = lookup_s * 1e6 + gate_hold_us
            admission_us = (time.perf_counter() - t0) * 1e6
            loaded_blocks = loaded_tokens // bt
            raced = hit_tokens > 0 and loaded_tokens == 0
            if loaded_blocks < n_blocks:
                # The compute phase's gate wait counts toward gate_stall
                # too: misses never touch the gate at admission anymore, so
                # without this their "queued behind other requests" signal
                # (the thing gate_stall exists to expose) would read 0.
                t_g2 = time.perf_counter()
                kind = "prefill" if loaded_blocks == 0 else "resume"
                async with self.gate.exclusive(kind=kind):
                    gate_stall_us += (time.perf_counter() - t_g2) * 1e6
                    # Compute runs in an executor thread: the model call
                    # (and its sync) would otherwise pin the
                    # EVENT LOOP for the whole forward — freezing every
                    # other request's gate-free fetch completions, which is
                    # exactly the overlap this pipeline exists to create.
                    # The gate (held across the await) still serializes
                    # cache mutation.
                    loop = asyncio.get_running_loop()
                    mspan = tracing.start_span("model." + kind)
                    try:
                        if loaded_blocks == 0:
                            counted = await loop.run_in_executor(
                                None, self._prefill_full, token_ids, prompt_table
                            )
                        else:
                            counted = await loop.run_in_executor(
                                None,
                                self._chunked_resume,
                                token_ids,
                                table,
                                loaded_blocks,
                            )
                        if counted is not None:
                            device_counts.stamps.append((time.perf_counter(), *counted))
                            if mspan is not None:
                                mspan.annotate(**dict(zip(LaunchCounts.FIELDS, counted)))
                    finally:
                        if mspan is not None:
                            mspan.finish()
            t_ready = time.perf_counter()
            prefix_ready_us = (t_ready - t0) * 1e6
            if rspan is not None:
                rspan.stage("prefix_ready", tracing.us_of_perf(t_ready))
            verified = None
            if self.verify:
                async with self.gate.shared(kind="verify"):
                    verified = self._verify_request(token_ids, prompt_table)
            # Save ONLY the computed suffix — the loaded prefix came from the
            # store and re-writing it would double write traffic for every
            # prefix hit.
            if loaded_blocks < n_blocks:
                await self._save_blocks(
                    token_ids, prompt_table[loaded_blocks:], loaded_blocks, "ttft"
                )
            generated = None
            ttft_us = 0.0
            if gen_tokens:
                generated, first_token_t = await self._generate(
                    token_ids, table, gen_tokens, priority=priority
                )
                if first_token_t is not None:
                    ttft_us = (first_token_t - t0) * 1e6
                # Save the COMPLETE blocks the response filled, keyed by the
                # extended chain (prompt + generated): a follow-up turn whose
                # prompt is this conversation so far gets a full prefix hit
                # instead of recomputing the response's KV (chain hashes
                # commit to the whole prefix, connector.py).
                full_ids = token_ids + generated
                full_blocks = len(full_ids) // bt
                if full_blocks > n_blocks:
                    await self._save_blocks(
                        full_ids, table[n_blocks:full_blocks], n_blocks, "response"
                    )
            moe = (0.0, 0.0, 0, 0.0)
            if device_counts is not None:
                # The last wave's copy was waited for by the response save's
                # snapshot (a final wave only runs when that save follows).
                device_counts.settle(time.perf_counter())
                moe = device_counts.totals()
            stats = RequestStats(
                tokens=len(token_ids),
                hit_blocks=hit_tokens // bt,
                loaded_blocks=loaded_blocks,
                computed_blocks=n_blocks - loaded_blocks,
                admission_us=admission_us,
                raced_eviction=raced,
                verified=verified,
                generated=generated,
                store_io_us=store_io_us,
                gate_stall_us=gate_stall_us,
                gate_hold_us=gate_hold_us,
                fetch_us=fetch_us,
                overlap_fraction=overlap,
                prefetched_blocks=(
                    prefetch.blocks_fetched if prefetch is not None else 0
                ),
                wasted_blocks=(
                    prefetch.wasted_blocks if prefetch is not None else 0
                ),
                prefix_ready_us=prefix_ready_us,
                ttft_us=ttft_us,
                priority=priority,
                moe_expert_reads=moe[0],
                moe_token_pairs=moe[1],
                moe_max_expert_rows=moe[2],
                window_keys_skipped=moe[3],
                device_counts=device_counts.stamps if device_counts is not None else [],
            )
            self.stats.append(stats)
            return stats
        except BaseException as e:
            # Explicit arm, not sys.exc_info()-in-finally: exc_info also
            # reports a CALLER's already-being-handled exception during a
            # normal return (a retry inside an except block would record a
            # successful request as failed).
            if rspan is not None:
                rspan.finish(status=f"error:{type(e).__name__}")
            raise
        finally:
            _DEVICE_COUNTS.reset(ctoken)
            tracing.unbind_span(rtoken)
            if fspan is not None:
                fspan.finish()  # idempotent: closed at primed() normally
            if rspan is not None:
                rspan.finish()  # idempotent: an error finish above wins
            if not prefetch_settled:
                # Admission died between enqueue and install (cancellation,
                # alloc backpressure unwound, model error): the speculative
                # fetch must hand every staging slot back — accounting
                # returns to baseline, the staged bytes count as waste.
                # shield(): even if THIS task is being cancelled, the
                # discard runs to completion (in the background if need be).
                try:
                    await asyncio.shield(prefetch.discard())
                except BaseException:  # noqa: BLE001 - cleanup must not mask
                    pass
                self._prefetch_extra_fetched += prefetch.blocks_fetched
                self._prefetch_extra_wasted += prefetch.wasted_blocks
            if table is not None:
                await self.pool.free(table)
            self.live -= 1

    async def run(
        self,
        prompts: Sequence[Sequence[int]],
        concurrency: int = 4,
        gen_tokens: int = 0,
    ):
        """Run all prompts with bounded request concurrency (optionally
        generating ``gen_tokens`` greedy tokens each via lockstep wave
        decode); returns the aggregate metrics dict."""
        sem = asyncio.Semaphore(concurrency)

        async def one(p):
            async with sem:
                return await self.run_request(p, gen_tokens=gen_tokens)

        await asyncio.gather(*(one(p) for p in prompts))
        return self.metrics()

    def metrics(self) -> dict:
        """Aggregate engine-side metrics over every completed request.

        Keys (the ``engine_*`` bench-receipt vocabulary, counters-checked
        against this list): ``requests``, ``hit_rate``, ``loaded_blocks``,
        ``computed_blocks``, ``raced_evictions``; admission latency
        ``p50_admission_us`` / ``p99_admission_us`` decomposed into the
        store's own cost (``p50_store_io_us``, ``p99_store_io_us``, split
        by outcome as ``p50_store_io_hit_us`` / ``p50_store_io_miss_us``)
        vs device-gate queueing (``p50_gate_stall_us``,
        ``p99_gate_stall_us``); the two-phase admission overlap story
        (``p50_gate_hold_us``, ``p99_gate_hold_us``, ``overlap_fraction``,
        ``prefetch_waste``, ``prefetch_fallbacks``,
        ``tier_direct_loads`` — cold-only roots read DIRECTLY via the
        one-phase load, skipping staged prefetch, docs/tiering.md) and
        end-to-end prefix residency (``p50_prefix_ready_hit_us``,
        ``p50_prefix_ready_miss_us``); the recompute ledger
        (``recompute_saved_s``, ``prefill_per_block_s``); concurrency
        receipts (``max_live_requests``, ``max_concurrent_saves``); the
        ragged wave-decode story (``decode_waves``, ``max_wave_size``,
        ``wave_buckets`` — distinct padded (B, T, P) launch shapes —
        ``wave_prewarmed_buckets`` — the canonical ladder
        ``prewarm_wave_buckets`` ran at startup — and
        ``wave_pad_fraction``, the share of launched wave rows that were
        padding); the skew-aware flush policy's ledger
        (docs/serving_load.md: ``wave_deferrals``,
        ``wave_aging_escapes`` — deferred entries force-launched at the
        starvation bound, ``wave_held_flushes`` — whole flushes held by
        the EWMA wave-size target, ``wave_defer_age_us_p99``); how the
        waves launched (``wave_graph_replays``, ``wave_graph_captures``,
        ``wave_eager``: CUDA graph replays, captures, eager waves) and
        serving latency (``p50_ttft_us``, ``p99_ttft_us``,
        ``p99_ttft_fg_us`` — time to first generated token, overall and
        FOREGROUND-class only); the device counters of a model with routed
        experts or sliding windows (``moe_expert_reads``, ``moe_token_pairs``
        and ``window_keys_skipped`` summed over the requests,
        ``moe_max_expert_rows`` their largest; ``RequestStats``);
        generation/speculation (``generated_tokens``,
        ``spec_tokens_per_step``, ``spec_acceptance_rate``,
        ``spec_drafted_tokens``, ``spec_accepted_tokens``);
        ``all_verified``; and, over a self-healing pool, ``store_health``.
        """
        total_blocks = sum(s.hit_blocks + s.computed_blocks for s in self.stats)
        loaded = sum(s.loaded_blocks for s in self.stats)
        lat = sorted(s.admission_us for s in self.stats)
        io = sorted(s.store_io_us for s in self.stats)
        io_hit = sorted(s.store_io_us for s in self.stats if s.loaded_blocks)
        io_miss = sorted(s.store_io_us for s in self.stats if not s.loaded_blocks)
        stall = sorted(s.gate_stall_us for s in self.stats)
        # Gate HOLD is only meaningful where a load/install ran (hits, or
        # the one-phase fallback); zeros from pure misses would drown it.
        hold = sorted(s.gate_hold_us for s in self.stats if s.gate_hold_us > 0)
        overlaps = [
            s.overlap_fraction for s in self.stats if s.overlap_fraction is not None
        ]
        prefetched = (
            sum(s.prefetched_blocks for s in self.stats)
            + self._prefetch_extra_fetched
        )
        wasted = (
            sum(s.wasted_blocks for s in self.stats) + self._prefetch_extra_wasted
        )
        ready_hit = sorted(s.prefix_ready_us for s in self.stats if s.loaded_blocks)
        ready_miss = sorted(
            s.prefix_ready_us for s in self.stats if not s.loaded_blocks
        )
        ttft = sorted(s.ttft_us for s in self.stats if s.ttft_us > 0)
        ttft_fg = sorted(
            s.ttft_us for s in self.stats
            if s.ttft_us > 0 and s.priority != PRIORITY_BACKGROUND
        )

        def _p(xs, q):
            return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else 0.0

        def pctl(q):
            return _p(lat, q)

        per_block = self._prefill_per_block_s or 0.0
        return {
            "requests": len(self.stats),
            "hit_rate": loaded / total_blocks if total_blocks else 0.0,
            "loaded_blocks": loaded,
            "computed_blocks": sum(s.computed_blocks for s in self.stats),
            "raced_evictions": sum(s.raced_eviction for s in self.stats),
            "p50_admission_us": pctl(0.50),
            "p99_admission_us": pctl(0.99),
            # Admission decomposed (RequestStats): the store's own cost vs
            # time queued behind other requests' compute for the device
            # gate. Optimizing the store moves the first; only engine
            # scheduling moves the second.
            "p50_store_io_us": _p(io, 0.50),
            "p99_store_io_us": _p(io, 0.99),
            # Split by outcome: a miss costs one lookup round trip; a hit
            # adds the whole load pipeline (fetch + H2D + scatter).
            "p50_store_io_hit_us": _p(io_hit, 0.50),
            "p50_store_io_miss_us": _p(io_miss, 0.50),
            "p50_gate_stall_us": _p(stall, 0.50),
            "p99_gate_stall_us": _p(stall, 0.99),
            # Two-phase admission: how long the exclusive gate was HELD for
            # installs (the only store-side phase that still serializes the
            # device), what fraction of store fetch time ran gate-free
            # (1.0 = I/O fully hidden), and the speculation's waste ratio
            # (staged blocks that never reached the device / staged blocks).
            "p50_gate_hold_us": _p(hold, 0.50),
            "p99_gate_hold_us": _p(hold, 0.99),
            "overlap_fraction": (
                sum(overlaps) / len(overlaps) if overlaps else 0.0
            ),
            "prefetch_waste": wasted / prefetched if prefetched else 0.0,
            "prefetch_fallbacks": self.prefetch_fallbacks,
            # Tiered capacity plane (docs/tiering.md): admissions that
            # skipped the staged prefetch for a cold-only root and read it
            # directly from the pooled cold tier via the one-phase load.
            "tier_direct_loads": self.tier_direct_loads,
            # End-to-end prefix residency split by outcome: the number that
            # says whether a cache hit actually beats recomputing.
            "p50_prefix_ready_hit_us": _p(ready_hit, 0.50),
            "p50_prefix_ready_miss_us": _p(ready_miss, 0.50),
            "recompute_saved_s": loaded * per_block,
            "prefill_per_block_s": per_block,
            "max_live_requests": self.max_live,
            "max_concurrent_saves": self.max_concurrent_saves,
            "decode_waves": self.wave.waves,
            "max_wave_size": self.wave.max_wave,
            # Distinct PADDED (B, T, P) launch shapes of the ragged wave
            # step.
            "wave_buckets": sorted(self.wave.bucket_sizes),
            # The canonical ladder prewarm_wave_buckets ran at
            # startup (policy on): serving must mint nothing beyond it.
            "wave_prewarmed_buckets": sorted(self.wave.prewarmed),
            # Share of launched wave rows that were padding (ragged
            # assembly pads only the flat tail; the old rectangle padded
            # every short chunk to the widest one) — the attribution key
            # for the ragged win.
            "wave_pad_fraction": (
                self.wave.pad_rows / self.wave.launched_rows
                if self.wave.launched_rows
                else 0.0
            ),
            # Skew-aware flush policy (docs/serving_load.md): the per-
            # harness deferral ledger (the process-wide WaveCounters
            # singleton aggregates the same events for /metrics), and
            # time-to-first-token — the latency figure the policy is
            # graded on, split so the FOREGROUND class's tail is visible
            # next to the mixed one.
            "wave_deferrals": self.wave.deferrals,
            "wave_aging_escapes": self.wave.aging_escapes,
            "wave_held_flushes": self.wave.held_flushes,
            "wave_defer_age_us_p99": _p(sorted(self.wave.defer_ages_us), 0.99),
            # How the waves launched (WaveDecoder docstring): replays of a
            # rung's CUDA graph, the waves that captured one, and waves run
            # eagerly (every wave on the CPU; on a card, above the top rung).
            "wave_graph_replays": self.wave.graph_replays,
            "wave_graph_captures": self.wave.graph_captures,
            "wave_eager": self.wave.eager_waves,
            "p50_ttft_us": _p(ttft, 0.50),
            "p99_ttft_us": _p(ttft, 0.99),
            "p99_ttft_fg_us": _p(ttft_fg, 0.99),
            "moe_expert_reads": sum(s.moe_expert_reads for s in self.stats),
            "moe_token_pairs": sum(s.moe_token_pairs for s in self.stats),
            "moe_max_expert_rows": max((s.moe_max_expert_rows for s in self.stats), default=0),
            "window_keys_skipped": sum(s.window_keys_skipped for s in self.stats),
            "generated_tokens": sum(
                len(s.generated) for s in self.stats if s.generated
            ),
            # Speculative decoding (drafter set): emitted tokens per verify
            # round (> 1.0 means speculation is paying), and the drafter's
            # acceptance rate. Without a drafter, rounds == tokens (1.0).
            "spec_tokens_per_step": (
                sum(len(s.generated) for s in self.stats if s.generated)
                / self.spec_rounds
                if self.spec_rounds
                else 0.0
            ),
            "spec_acceptance_rate": (
                self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0
            ),
            "spec_drafted_tokens": self.spec_drafted,
            "spec_accepted_tokens": self.spec_accepted,
            "all_verified": all(
                s.verified for s in self.stats if s.verified is not None
            ),
            **self._store_health(),
        }

    def _store_health(self) -> dict:
        """Failure-domain visibility at the engine's own dashboard: when the
        connector under the adapter is a self-healing pool
        (ClusterKVConnector.health), surface its per-member breaker states
        and degrade counters — the operator reading engine metrics is the
        one who needs to know WHICH cache node is sick."""
        health = getattr(
            getattr(self.adapter, "connector", None), "health", None
        )
        if not callable(health):
            return {}
        try:
            return {"store_health": health()}
        except Exception:  # noqa: BLE001 - metrics must never kill the engine
            return {}
