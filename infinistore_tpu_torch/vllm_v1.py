"""vLLM v1 ``KVConnectorBase_V1`` implementation over the InfiniStore-TPU store
(port of ``infinistore_tpu/vllm_v1.py``).

The reference's entire reason to exist is serving vLLM through LMCache
(reference README.md:22, docs/source/design.rst:33-37). vLLM v1 made that
seam a first-class plugin: ``KVConnectorBase_V1``
(vllm/distributed/kv_transfer/kv_connector/v1/base.py) with a scheduler-side
half that decides WHAT to transfer and a worker-side half that moves bytes
during the forward pass, connected by an opaque metadata object the scheduler
builds each step and the runner binds before the model runs. This module
implements that published contract — same method names, signatures, call
order, and role split — so attaching this store to a vLLM engine is
``--kv-connector InfiniStoreKVConnectorV1`` configuration, not engine code.
The scheduler half is the JAX package's code; the worker half moves torch
tensors through the port's ``KVConnector`` (K1 gathers, K2 scatters on
CUDA).

Published call order (the contract tests in tests/test_vllm_v1.py drive
exactly this):

  scheduler, per request:  get_num_new_matched_tokens -> (engine allocates)
                           -> update_state_after_alloc
  scheduler, per step:     build_connector_meta  (ships to the worker)
  worker, per step:        bind_connector_metadata -> start_load_kv
                           -> [per layer: wait_for_layer_load BEFORE the
                               layer's attention reads the cache;
                               save_kv_layer AFTER the layer's KV insert]
                           -> wait_for_save -> clear_connector_metadata
  scheduler, at finish:    request_finished

Three deliberate adaptations, all documented on the methods:

- **Caches are the caller's tensors, updated in place.** As in vLLM's torch
  connectors, a load scatters into the worker's paged KV tensors (K2 on
  CUDA writes in place), so ``register_kv_caches`` keeps the caller's
  ``(K, V)`` tensors and ``kv_cache(layer_name)`` returns them. A load that
  hands back a list without firing its per-layer hook (the quantized
  connector's scales-race miss returns new tuples) still has that list
  installed, so ``kv_cache`` always names what the load left.

- **Layer readiness on the card.** The worker's loads run on the I/O
  thread, on a stream of their own (``load stream``) ordered after the
  runner's work at ``start_load_kv``. A layer's per-layer hook fires when
  its K2 scatter has been ENQUEUED, not completed, so the hook records a
  CUDA event on the stream that holds the scatter, and
  ``wait_for_layer_load`` makes the runner's current stream wait on it: the
  layer's attention is ordered after the scatter on the device, with no host
  synchronisation. The opposite direction needs no event: ``save_kv_layer``
  runs on the runner's thread, and ``KVConnector.stage_layer_save`` gathers
  (K1) on that thread's current stream, after the layer's KV insert, and
  its device-to-host copy waits for that stream.

- **Sentinel-honoring layer-wise save.** ``save_kv_layer`` streams each
  layer out as its forward completes (the reference's layer-wise overlap,
  design.rst:54-63) — except layer 0, whose store keys are the
  whole-block presence sentinel (connector.py lookup): its bytes are
  staged immediately but its PUT is deferred to ``wait_for_save``, after
  every deeper layer committed. A concurrent lookup therefore never sees
  a half-saved block as a hit.

The scheduler and worker halves are separate instances (vLLM runs them in
separate processes); each builds its own store connection. Loads run on a
private background event loop owned by the worker half — the store's
asyncio ops bind to the loop that awaits them (lib.py), and vLLM's runner
calls are synchronous.
"""

import asyncio
import enum
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import wire
from .connector import KVConnector  # noqa: F401 - the canonical surface
from .cuda.staging import StagingPoolExhausted


class KVLoadUnderDelivery(RuntimeError):
    """A load delivered fewer tokens than the scheduler was promised.

    Stock vLLM counts the promised tokens as computed the moment the
    scheduler builds the step, so silently under-delivering (a store-side
    eviction racing the load) would make the engine attend over zero-filled
    blocks and emit wrong output. Raised from ``wait_for_layer_load`` /
    ``wait_for_save`` unless the engine opts into the ``loaded_tokens()``
    recompute protocol (``allow_partial_delivery`` in the connector's extra
    config)."""


class KVConnectorRole(enum.Enum):
    """Which half of the engine this instance serves (published enum)."""

    SCHEDULER = 0
    WORKER = 1


class KVConnectorMetadata:
    """Opaque scheduler->worker payload (published base: an empty marker
    class; concrete connectors subclass it)."""


@dataclass
class _LoadSpec:
    """One request's prefix load, decided scheduler-side."""

    req_id: str
    token_ids: List[int]
    block_ids: np.ndarray  # engine physical blocks for the loaded span
    num_tokens: int  # external tokens to load (block-aligned)
    first_block: int  # logical block where the external span starts


@dataclass
class _SaveSpec:
    """One request's computed-suffix save."""

    req_id: str
    token_ids: List[int]
    block_ids: np.ndarray  # physical blocks holding the computed suffix
    first_block: int  # logical index of block_ids[0] within the prompt


@dataclass
class InfiniStoreConnectorMetadata(KVConnectorMetadata):
    """Per-step transfer plan: built by the scheduler half, consumed by the
    worker half."""

    loads: List[_LoadSpec] = field(default_factory=list)
    saves: List[_SaveSpec] = field(default_factory=list)


class KVConnectorBase_V1(ABC):
    """The published vLLM v1 connector contract, mirrored method-for-method
    (vllm/distributed/kv_transfer/kv_connector/v1/base.py). vLLM is not a
    dependency of this package, so the ABC is restated here; the signatures
    and the scheduler/worker role split are the published ones — a vLLM tree
    can subclass its own base instead and reuse ``InfiniStoreKVConnectorV1``
    unchanged."""

    def __init__(self, vllm_config, role: "KVConnectorRole"):
        self._connector_metadata: Optional[KVConnectorMetadata] = None
        self.role = role

    # -- worker-side ---------------------------------------------------------

    def bind_connector_metadata(self, connector_metadata: KVConnectorMetadata):
        """Runner installs this step's metadata before the forward pass."""
        self._connector_metadata = connector_metadata
        self._reset_step_state()

    def _reset_step_state(self):
        """Hook for subclasses with per-step worker state (overridden by
        the concrete connector; the base has none)."""

    def clear_connector_metadata(self):
        """Runner clears it after the step."""
        self._connector_metadata = None

    @abstractmethod
    def start_load_kv(self, forward_context, **kwargs) -> None:
        """Begin loading external KV for the bound metadata's requests."""

    @abstractmethod
    def wait_for_layer_load(self, layer_name: str) -> None:
        """Block until ``layer_name``'s load landed (called before that
        layer's attention)."""

    @abstractmethod
    def save_kv_layer(self, layer_name: str, kv_layer, attn_metadata, **kwargs) -> None:
        """Start saving ``layer_name`` (called after that layer's forward)."""

    @abstractmethod
    def wait_for_save(self) -> None:
        """Block until every save issued this step is durable."""

    def get_finished(self, finished_req_ids) -> Tuple[Optional[set], Optional[set]]:
        """(sending-finished, recving-finished) request ids for ASYNC
        transfer connectors. Ours completes synchronously within the step
        (wait_for_save / wait_for_layer_load), so there is never a deferred
        set: (None, None) — the published 'nothing outstanding' answer."""
        return None, None

    # -- scheduler-side ------------------------------------------------------

    @abstractmethod
    def get_num_new_matched_tokens(
        self, request, num_computed_tokens: int
    ) -> Tuple[int, bool]:
        """(tokens available externally BEYOND num_computed_tokens,
        load_is_async)."""

    @abstractmethod
    def update_state_after_alloc(self, request, blocks, num_external_tokens: int):
        """Engine allocated blocks for the promised external tokens."""

    @abstractmethod
    def build_connector_meta(self, scheduler_output) -> KVConnectorMetadata:
        """Assemble this step's metadata and RESET per-step scheduler state."""

    def request_finished(self, request, block_ids) -> Tuple[bool, Optional[dict]]:
        """Request left the engine. Returns (delay_block_free, transfer
        params for the response). Saves here are synchronous within the
        step, so blocks never need delayed freeing."""
        return False, None


def _iter_cached_reqs(cached):
    """Yield (req_id, new_block_ids, num_computed_tokens, resumed) from
    vLLM's ``scheduled_cached_reqs``, duck-typing both published shapes: a
    list of CachedRequestData objects, or the newer struct-of-arrays object
    with parallel ``req_ids`` / ``new_block_ids`` / ``num_computed_tokens``
    / ``resumed_from_preemption``."""
    if cached is None:
        return
    req_ids = getattr(cached, "req_ids", None)
    if req_ids is not None:
        n = len(req_ids)
        new_blocks = getattr(cached, "new_block_ids", None) or [None] * n
        computed = getattr(cached, "num_computed_tokens", None) or [0] * n
        resumed = (
            getattr(cached, "resumed_from_preemption", None) or [False] * n
        )
        yield from zip(req_ids, new_blocks, computed, resumed)
        return
    for r in cached:
        yield (
            r.req_id,
            getattr(r, "new_block_ids", None),
            getattr(r, "num_computed_tokens", 0),
            getattr(r, "resumed_from_preemption", False),
        )


def _block_ids_of(blocks) -> np.ndarray:
    """Accept vLLM's KVCacheBlocks (``get_block_ids()`` -> [[ids]]), its
    per-group nested lists ([[ids]], one entry per KV cache group — we
    serve group 0, the standard full-attention group), or a plain id
    sequence."""
    if hasattr(blocks, "get_block_ids"):
        return np.asarray(blocks.get_block_ids()[0], dtype=np.int32)
    seq = list(blocks)
    if seq and isinstance(seq[0], (list, tuple, np.ndarray)):
        seq = list(seq[0])
    return np.asarray(seq, dtype=np.int32)


class InfiniStoreKVConnectorV1(KVConnectorBase_V1):
    """The store's vLLM v1 connector.

    ``vllm_config`` duck-types vLLM's config object: the connector reads
    ``vllm_config.kv_transfer_config.kv_connector_extra_config`` (falling
    back to ``vllm_config`` itself being that dict) and expects one key,
    ``"kv_connector"``: a built :class:`~infinistore_tpu_torch.connector.KVConnector`
    binding the model's cache spec to a store connection. Each role builds
    its own (scheduler and worker live in different processes in vLLM).
    """

    def __init__(self, vllm_config, role: KVConnectorRole):
        super().__init__(vllm_config, role)
        extra = vllm_config
        ktc = getattr(vllm_config, "kv_transfer_config", None)
        if ktc is not None:
            extra = getattr(ktc, "kv_connector_extra_config", ktc)
        if isinstance(extra, dict):
            kv = extra.get("kv_connector")
        else:
            kv = getattr(extra, "kv_connector", None)
        # Duck-typed, not isinstance: ClusterKVConnector (cluster.py) and
        # any KVConnector-shaped member expose the same surface, so a
        # pooled store drops in here with no engine-side change.
        needed = ("spec", "lookup", "load", "stage_layer_save")
        missing = [a for a in needed if not hasattr(kv, a)]
        if missing:
            raise ValueError(
                "kv_connector_extra_config['kv_connector'] must expose the "
                f"KVConnector surface ({', '.join(needed)}); "
                f"{type(kv).__name__} lacks {', '.join(missing)}"
            )
        self.kv = kv
        self.block_tokens = kv.spec.block_tokens
        # Opt-in to graceful under-delivery: the engine promises to call
        # loaded_tokens() and recompute the shortfall. Without it, a load
        # delivering less than promised fails the step loudly
        # (KVLoadUnderDelivery) — stock vLLM would otherwise attend over
        # zero-filled blocks.
        if isinstance(extra, dict):
            self._allow_partial = bool(extra.get("allow_partial_delivery", False))
        else:
            self._allow_partial = bool(
                getattr(extra, "allow_partial_delivery", False)
            )
        # scheduler-side per-step state
        self._pending_loads: Dict[str, _LoadSpec] = {}
        self._probed_tokens: Dict[str, int] = {}  # req -> engine-computed blocks
        self._store_hits: Dict[str, int] = {}  # req -> store's hit blocks
        # scheduler-side per-REQUEST state (persists across steps; cleared
        # in request_finished): chunked prefill's later chunks arrive via
        # scheduled_cached_reqs carrying no prompt tokens, so the first
        # step's data and a saved-block watermark must be remembered or the
        # tail of a long prompt never reaches the store.
        self._save_watermark: Dict[str, int] = {}  # req -> blocks saved/stored
        self._req_tokens: Dict[str, List[int]] = {}
        self._req_blocks: Dict[str, List[int]] = {}
        # worker-side state
        self._layer_names: List[str] = []
        self._layer_index: Dict[str, int] = {}
        self._kv_caches: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._kv_lock = threading.Lock()
        self._load_done: List[threading.Event] = []
        # Per layer, the CUDA events recorded after this step's scatters into
        # it (none on the CPU), and the stream the loads run on.
        self._layer_ready: List[list] = []
        self._load_stream = None
        self.load_seconds = 0.0  # host time of the last step's loads
        self._load_error: Optional[BaseException] = None
        self._loaded_tokens: Dict[str, int] = {}
        self._save_futures: list = []
        self._deferred_sentinels: list = []
        self._load_future = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None

    # ======================================================================
    # scheduler side
    # ======================================================================

    def get_num_new_matched_tokens(self, request, num_computed_tokens: int):
        """Probe the store for this prompt's longest cached prefix (one
        control round trip — connector.py lookup) and promise the tokens
        the engine does NOT already have locally. Block-aligned both ways:
        ``num_computed_tokens`` is floored to the block grid before
        subtracting, so a partially-computed block never double-counts.
        The promise is capped so AT LEAST ONE prompt token remains for the
        engine to compute — vLLM's scheduler requires a non-empty local
        step per request (the same cap every published connector applies);
        the cap drops whole blocks, keeping loads block-granular.
        Returns (count, False): loads complete inside the step via
        wait_for_layer_load, never asynchronously across steps."""
        hit_blocks = self.kv.lookup(request.prompt_token_ids)
        computed_blocks = num_computed_tokens // self.block_tokens
        external = max(0, (hit_blocks - computed_blocks) * self.block_tokens)
        cap = len(request.prompt_token_ids) - num_computed_tokens - 1
        if external > cap:
            external = max(0, (cap // self.block_tokens) * self.block_tokens)
        self._probed_tokens[request.request_id] = computed_blocks
        self._store_hits[request.request_id] = hit_blocks
        return external, False

    def update_state_after_alloc(self, request, blocks, num_external_tokens: int):
        """Record the engine's physical placement for the promised tokens.
        ``blocks`` covers the whole request; the external span occupies the
        entries just after the engine's locally-computed prefix, so the
        load targets ``blocks[computed : computed + external]`` and fetches
        exactly the chain span it promised (KVConnector.load first_block)."""
        if num_external_tokens <= 0:
            return
        ids = _block_ids_of(blocks)
        skip = self._probed_tokens.get(request.request_id, 0)
        n_blocks = num_external_tokens // self.block_tokens
        self._pending_loads[request.request_id] = _LoadSpec(
            req_id=request.request_id,
            token_ids=list(request.prompt_token_ids),
            block_ids=ids[skip : skip + n_blocks],
            num_tokens=n_blocks * self.block_tokens,
            first_block=skip,
        )

    def build_connector_meta(self, scheduler_output) -> InfiniStoreConnectorMetadata:
        """Assemble this step's plan: the loads recorded since the last
        build, plus a save of every scheduled request's computed suffix
        (the loaded prefix is already stored — re-saving it would double
        write traffic on every hit). PER-STEP scheduler state resets here;
        per-REQUEST state (the saved-block watermark) persists across
        steps so a chunked prefill's later chunks — which arrive via
        ``scheduled_cached_reqs`` with no prompt data — still emit their
        saves, and is cleared in ``request_finished``."""
        meta = InfiniStoreConnectorMetadata(loads=list(self._pending_loads.values()))
        # Chunked prefill: scheduler_output.num_scheduled_tokens (vLLM's
        # per-request dict) bounds what this step actually computes; only
        # blocks COMPLETE by end of step may be saved — committing an
        # unscheduled block would publish garbage under a valid chain key.
        # Absent the attribute, the whole prompt runs this step.
        num_sched = getattr(scheduler_output, "num_scheduled_tokens", None) or {}
        for req in getattr(scheduler_output, "scheduled_new_reqs", []):
            rid = req.req_id
            ids = _block_ids_of(req.block_ids)
            end_tokens = len(req.prompt_token_ids)
            if rid in num_sched:
                end_tokens = min(
                    end_tokens, req.num_computed_tokens + num_sched[rid]
                )
            end_blocks = end_tokens // self.block_tokens
            # Everything the store already holds — the probed hit prefix —
            # is skipped; blocks the engine computed LOCALLY beyond the
            # store's hit (its own prefix cache outran the store) are saved
            # too, or the store could never learn them.
            hit = self._store_hits.get(rid, 0)
            start = max(min(hit, end_blocks), self._save_watermark.get(rid, 0))
            if end_blocks > start:
                meta.saves.append(
                    _SaveSpec(
                        req_id=rid,
                        token_ids=list(req.prompt_token_ids),
                        block_ids=ids[start:end_blocks],
                        first_block=start,
                    )
                )
            # Remember what a resumed (cached) step will need, and advance
            # the watermark past everything now saved OR already in store.
            self._req_tokens[rid] = list(req.prompt_token_ids)
            self._req_blocks[rid] = [int(i) for i in ids]
            self._save_watermark[rid] = max(hit, end_blocks)
        for rid, new_ids, num_computed, resumed in _iter_cached_reqs(
            getattr(scheduler_output, "scheduled_cached_reqs", None)
        ):
            tokens = self._req_tokens.get(rid)
            if tokens is None:
                continue  # not a request we admitted (or already finished)
            if resumed:
                # Preemption freed (and likely re-used) every old physical
                # block; new_block_ids is the FULL replacement list, not an
                # extension — appending would misalign logical->physical
                # and gather other requests' data under this prompt's
                # chain keys. The watermark survives: already-saved blocks
                # are content-addressed by tokens and stay valid.
                self._req_blocks[rid] = []
            blocks = self._req_blocks.setdefault(rid, [])
            if new_ids is not None:
                ext = _block_ids_of(new_ids)
                if len(ext):
                    blocks.extend(int(i) for i in ext)
            end_tokens = len(tokens)
            if rid in num_sched:
                end_tokens = min(end_tokens, int(num_computed) + num_sched[rid])
            end_blocks = min(end_tokens // self.block_tokens, len(blocks))
            start = self._save_watermark.get(rid, 0)
            if end_blocks > start:
                meta.saves.append(
                    _SaveSpec(
                        req_id=rid,
                        token_ids=list(tokens),
                        block_ids=np.asarray(blocks[start:end_blocks], np.int32),
                        first_block=start,
                    )
                )
                self._save_watermark[rid] = end_blocks
        self._pending_loads.clear()
        self._probed_tokens.clear()
        self._store_hits.clear()
        return meta

    def request_finished(self, request, block_ids) -> Tuple[bool, Optional[dict]]:
        """Request left the engine: drop its cross-step tracking (saved-
        block watermark, remembered prompt/blocks). Saves are synchronous
        within the step, so blocks never need delayed freeing."""
        rid = getattr(request, "request_id", None) or getattr(
            request, "req_id", None
        )
        if rid is not None:
            self._save_watermark.pop(rid, None)
            self._req_tokens.pop(rid, None)
            self._req_blocks.pop(rid, None)
        return False, None

    # ======================================================================
    # worker side
    # ======================================================================

    def register_kv_caches(self, kv_caches: Dict[str, Tuple[torch.Tensor, torch.Tensor]]):
        """Install the engine's paged caches, one (K, V) pair per layer, in
        FORWARD ORDER (dict order = layer order, as vLLM's runner builds
        it). The connector keeps the caller's tensors: loads scatter into
        them in place (K2 on CUDA), so the runner's own references see the
        loaded bytes; ``kv_cache``/``kv_caches`` return the same tensors.
        On CUDA the loads get a stream of their own on the caches' device."""
        self._layer_names = list(kv_caches.keys())
        self._layer_index = {n: i for i, n in enumerate(self._layer_names)}
        self._kv_caches = [kv_caches[n] for n in self._layer_names]
        device = self._kv_caches[0][0].device if self._kv_caches else None
        self._load_stream = (
            torch.cuda.Stream(device) if device is not None and device.type == "cuda"
            else None
        )

    def kv_cache(self, layer_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Current (K, V) tensors for a layer: the registered ones, which a
        load fills in place (or the list a hook-less load returned)."""
        with self._kv_lock:
            return self._kv_caches[self._layer_index[layer_name]]

    def kv_caches(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Current per-layer cache list (forward order)."""
        with self._kv_lock:
            return list(self._kv_caches)

    def loaded_tokens(self, req_id: str) -> int:
        """Tokens actually delivered for a request this step (== the
        promise unless a store-side eviction raced the load; cache
        semantics — the engine recomputes the difference)."""
        return self._loaded_tokens.get(req_id, 0)

    def _reset_step_state(self):
        """A step aborted mid-forward (load error, engine preemption) must
        not leak its staged saves into the next step: a stale layer-0
        sentinel shipping later would publish presence for blocks whose
        deeper layers never committed — a poisoned prefix every consumer
        would hit. Dropping the sentinels keeps the aborted step invisible
        (deeper-layer puts that already landed are unreachable without the
        sentinel, and get overwritten on the retry)."""
        self._deferred_sentinels = []
        self._save_futures = []

    def _ensure_loop(self) -> asyncio.AbstractEventLoop:
        if self._loop is None:
            loop = asyncio.new_event_loop()

            def run():
                asyncio.set_event_loop(loop)
                loop.run_forever()

            t = threading.Thread(target=run, name="infinistore-v1-io", daemon=True)
            t.start()
            self._loop, self._loop_thread = loop, t
        return self._loop

    def _readiness_event(self):
        """An event recorded on the current stream of the caches' device
        (the stream that holds the scatters just enqueued), or None on the
        CPU, where a scatter has completed when it returns."""
        if self._load_stream is None:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._load_stream.device))
        return event

    def _wait_ready(self, layers) -> None:
        """Make the caller's current stream wait, on the device, for the
        scatters recorded into ``layers``; each event is consumed once."""
        stream = (None if self._load_stream is None
                  else torch.cuda.current_stream(self._load_stream.device))
        for layer in layers:
            events, self._layer_ready[layer] = self._layer_ready[layer], []
            for event in events:
                event.wait(stream)

    def start_load_kv(self, forward_context, **kwargs) -> None:
        """Kick off this step's loads on the background I/O loop.

        Requests install SEQUENTIALLY (their scatters share the cache
        tensors and queue on one stream, and a sequential install keeps the
        per-layer accounting exact; the engine harness's DeviceGate exists
        for the same reason), but each request's layers pipeline internally
        (LayerwiseKVReader overlaps fetch/H2D/scatter). Per-layer progress
        feeds ``wait_for_layer_load``: layer L's event fires once EVERY
        request's layer L landed.

        On CUDA the loads run on the connector's load stream, which first
        waits (on the device) for the work queued so far on the caller's
        current stream: the caches' creation and the runner's earlier
        writes."""
        meta = self._connector_metadata
        if not isinstance(meta, InfiniStoreConnectorMetadata):
            raise RuntimeError(
                "start_load_kv before bind_connector_metadata (the runner "
                "must bind this step's metadata first)"
            )
        num_layers = len(self._kv_caches)
        if num_layers == 0:
            raise RuntimeError("register_kv_caches was never called")
        self._load_error = None
        self._loaded_tokens = {}
        self._load_future = None
        self._load_done = [threading.Event() for _ in range(num_layers)]
        self._layer_ready = [[] for _ in range(num_layers)]
        self.load_seconds = 0.0
        loads = list(meta.loads)
        if not loads:
            for ev in self._load_done:
                ev.set()
            return
        remaining = [len(loads)] * num_layers
        if self._load_stream is not None:
            self._load_stream.wait_stream(
                torch.cuda.current_stream(self._load_stream.device))
        t0 = time.perf_counter()

        async def run_loads():
            if self._load_stream is not None:
                # The I/O thread is this connector's own: every scatter it
                # enqueues (the reader's, and an install's, which takes its
                # caller's stream into the executor) lands on the load stream.
                torch.cuda.set_stream(self._load_stream)
            try:
                # Phase 1 — start every request's GATE-FREE fetch now
                # (KVConnector.start_fetch): the whole wave's store reads
                # run concurrently and coalesce into shared batched calls
                # (a StripedConnection splits them across its stripes),
                # instead of each request's network time queueing behind
                # the previous request's install. A full staging arena
                # just drops that request back to the one-phase load.
                fetch_async = getattr(self.kv, "start_fetch_async", None)
                can_fetch = fetch_async is not None or hasattr(
                    self.kv, "start_fetch"
                )
                handles = []
                for spec in loads:
                    handle = None
                    if can_fetch:
                        try:
                            if fetch_async is not None:
                                # Probe RTT in an executor — one request's
                                # lookup must not stall the wave (ITS-L001).
                                handle = await fetch_async(
                                    spec.token_ids,
                                    first_block=spec.first_block,
                                    limit_blocks=len(spec.block_ids),
                                )
                            else:
                                # Audited: sync-only duck-typed connector —
                                # the inline probe is its documented cost.
                                handle = self.kv.start_fetch(  # its: allow[ITS-L001]
                                    spec.token_ids,
                                    first_block=spec.first_block,
                                    limit_blocks=len(spec.block_ids),
                                )
                        except StagingPoolExhausted:
                            handle = None
                    handles.append(handle)
                # Phase 2 — install sequentially (the installs scatter into
                # the shared cache tensors in place, on one stream), layer
                # by layer. Per-layer progress feeds ``wait_for_layer_load``:
                # layer L's event fires once EVERY request's layer L landed,
                # and each install records a CUDA event after its scatter.
                for spec, handle in zip(loads, handles):
                    fired = set()

                    def on_layer(layer, kv, fired=fired):
                        fired.add(layer)
                        ready = self._readiness_event()
                        with self._kv_lock:
                            self._kv_caches[layer] = kv
                            if ready is not None:
                                self._layer_ready[layer].append(ready)
                        remaining[layer] -= 1
                        if remaining[layer] == 0:
                            self._load_done[layer].set()

                    # Audited: microsecond list copy under an uncontended
                    # lock shared with the worker thread's layer waits.
                    with self._kv_lock:  # its: allow[ITS-L003]
                        caches = list(self._kv_caches)
                    if handle is not None:
                        _out, loaded = await handle.install(
                            caches,
                            spec.block_ids[: handle.n_blocks],
                            on_layer=on_layer,
                        )
                    else:
                        _out, loaded = await self.kv.load(
                            spec.token_ids,
                            caches,
                            spec.block_ids,
                            first_block=spec.first_block,
                            on_layer=on_layer,
                        )
                    self._loaded_tokens[spec.req_id] = loaded * self.block_tokens
                    # Settle layers on_layer never reached for THIS spec
                    # (no read at all, or a partial read that failed after
                    # some layers) — decrementing all layers again would
                    # release waits while a later spec's load is still
                    # scattering into the same tensors. A hook-less return
                    # may still hand back a NEW list (the quantized
                    # connector's scales-race miss returns zipped new tuples
                    # and 0; K2 scatters in place, so they hold whatever the
                    # load wrote) — install the returned list, so kv_cache
                    # names what the load left, and record the load
                    # stream's readiness for those layers too.
                    unfired = [layer for layer in range(num_layers) if layer not in fired]
                    ready = self._readiness_event() if unfired else None
                    for layer in unfired:
                        # Audited: single-item assignment, same lock
                        # discipline as above.
                        with self._kv_lock:  # its: allow[ITS-L003]
                            if _out is not None and _out[layer] is not caches[layer]:
                                self._kv_caches[layer] = tuple(_out[layer])
                            if ready is not None:
                                self._layer_ready[layer].append(ready)
                        remaining[layer] -= 1
                        if remaining[layer] == 0:
                            self._load_done[layer].set()
                    if (
                        loaded * self.block_tokens < spec.num_tokens
                        and not self._allow_partial
                    ):
                        # The scheduler already counted the promise as
                        # computed; silently delivering less would make the
                        # engine attend over zero-filled blocks.
                        raise KVLoadUnderDelivery(
                            f"request {spec.req_id!r}: promised "
                            f"{spec.num_tokens} external tokens, delivered "
                            f"{loaded * self.block_tokens} (raced eviction?). "
                            "Opt into the loaded_tokens() recompute protocol "
                            "with allow_partial_delivery=True if the engine "
                            "recomputes shortfalls."
                        )
            except BaseException as e:  # noqa: BLE001 - surfaced by waits
                self._load_error = e
                # Unconsumed prefetches must hand their staging slots back.
                for h in handles:
                    if h is not None and h.blocks_installed == 0 and h.n_blocks:
                        try:
                            await h.discard()
                        except Exception:
                            pass
            finally:
                self.load_seconds = time.perf_counter() - t0
                for ev in self._load_done:
                    ev.set()

        self._load_future = asyncio.run_coroutine_threadsafe(
            run_loads(), self._ensure_loop()
        )

    def wait_for_layer_load(self, layer_name: str) -> None:
        """Block until every bound load delivered ``layer_name``. The
        runner calls this immediately before the layer's attention; layers
        complete in forward order, so by construction the wait for layer L
        overlaps the network/H2D work of layers > L (the reference's
        layer-wise streaming contract, design.rst:54-63).

        The host wait returns once the layer's scatters are enqueued; on
        CUDA the caller's current stream is then made to wait, on the
        device, for the events recorded after them, so the layer's attention
        (queued next on that stream) reads the loaded bytes."""
        layer = self._layer_index[layer_name]
        self._load_done[layer].wait()
        if self._load_error is not None:
            raise RuntimeError(
                f"KV load failed before {layer_name!r}"
            ) from self._load_error
        self._wait_ready([layer])

    def save_kv_layer(self, layer_name: str, kv_layer, attn_metadata, **kwargs) -> None:
        """Stream one layer's computed blocks to the store, overlapping the
        remaining layers' forward. ``kv_layer`` is the layer's (K, V) pair
        AFTER its KV insert (pass None to use the connector's current ref).
        Layer 0's bytes are gathered and staged NOW but its put is deferred
        to ``wait_for_save`` — layer-0 keys are the whole-block presence
        sentinel and must commit last (connector.py lookup)."""
        meta = self._connector_metadata
        if not isinstance(meta, InfiniStoreConnectorMetadata):
            raise RuntimeError("save_kv_layer before bind_connector_metadata")
        layer = self._layer_index[layer_name]
        # The gather below (K1 on CUDA) is enqueued on THIS thread's
        # current stream, behind the runner's KV insert for the layer.
        if kv_layer is None:
            kv_layer = self.kv_cache(layer_name)
        with self._kv_lock:
            self._kv_caches[layer] = tuple(kv_layer)
        loop = self._ensure_loop()
        for spec in meta.saves:
            # Gather + D2H start here (runner thread) so later compute
            # cannot perturb the shipped bytes; the network put is a pure-
            # await callable (KVConnector.stage_layer_save — also the seam
            # where ClusterKVConnector routes by chain root).
            # BACKGROUND named at source (ITS-P004): this is the engine's
            # own streamed save behind the forward pass, NOT a handoff a
            # decode consumer is waiting on — disagg.py ships FOREGROUND.
            ship = self.kv.stage_layer_save(
                spec.token_ids, layer, kv_layer, spec.block_ids,
                first_block=spec.first_block,
                priority=wire.PRIORITY_BACKGROUND,
            )
            if layer == 0:
                self._deferred_sentinels.append(ship)
            else:
                self._save_futures.append(
                    asyncio.run_coroutine_threadsafe(ship(), loop)
                )

    def wait_for_save(self) -> None:
        """Drain every non-sentinel save, then ship the deferred layer-0
        sentinel puts and drain those — after this returns, every block
        saved this step is durably visible, and only then does its
        presence sentinel exist. Also joins the step's LOAD pipeline:
        per-layer waits return at each layer's scatter, so the end-of-step
        accounting (``loaded_tokens``) settles here, and the caller's
        current stream waits for every scatter no layer wait consumed."""
        if self._load_future is not None:
            self._load_future.result()
            self._load_future = None
        if self._load_error is not None:
            # A failed or under-delivered load must not slip past the step
            # boundary just because no later layer wait observed it.
            raise RuntimeError("KV load failed this step") from self._load_error
        self._wait_ready(range(len(self._layer_ready)))
        try:
            for f in self._save_futures:
                f.result()
        finally:
            self._save_futures = []
        sentinels, self._deferred_sentinels = self._deferred_sentinels, []
        if sentinels:
            loop = self._ensure_loop()

            async def run_all():
                await asyncio.gather(*(p() for p in sentinels))

            asyncio.run_coroutine_threadsafe(run_all(), loop).result()

    def close(self):
        """Stop the background I/O loop (worker teardown)."""
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=5)
            self._loop = None
