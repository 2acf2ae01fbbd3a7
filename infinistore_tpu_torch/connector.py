"""Engine-facing KV-cache connector (port of ``infinistore_tpu/connector.py``:
``token_chain_hashes``, ``_ChainHashCache``, ``FetchCoalescer`` and
``KVConnector`` with lookup / save / load / start_fetch / start_fetch_async /
stage_layer_save / handoff / manifest / get_stats / drop; ``handoff`` moves
blocks device to device through ``cuda/ici.py``'s ``IciBlockTransfer`` when
one is bound, through the store otherwise).

A connector hashes token prefixes into chain keys, asks the store how much
of a prompt is already cached (``get_match_last_index``), and streams
paged-KV blocks layer by layer. It binds a paged cache spec + host staging
pool + store connection to a model id and exposes lookup / save / load in
engine terms (token ids and block ids).

Key scheme: ``{model}/L{layer}/{k|v}/{chain_hash_i}`` where ``chain_hash_i``
is a rolling SHA-256 over token blocks [0..i]. A block's key therefore
commits to the *entire prefix*, so two prompts share keys exactly for their
common block-aligned prefix. Keys, hashes and block bytes are identical to
the JAX package's, so a prefix either package saved loads in the other.
"""

import asyncio
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import tracing, wire
from .cuda import _ext
from .cuda.layerwise import (
    LayerwiseKVReader,
    LayerwiseKVWriter,
    LayerwisePrefetch,
    PartialReadError,
)
from .cuda.paged import PagedKVCacheSpec, gather_blocks_many
from .cuda.staging import HostStagingPool, StagingPoolExhausted
from .lib import (
    InfiniStoreColdTier,
    InfiniStoreKeyNotFound,
    InfiniStoreNoMatch,
    InfiniStoreResourcePressure,
)
from .tiering import note_demotion_hit as tiering_note_demotion_hit


def token_chain_hashes(token_ids: Sequence[int], block_tokens: int) -> List[str]:
    """Rolling prefix hash per *complete* token block.

    hash_i covers tokens [0, (i+1) * block_tokens); an incomplete tail block
    is excluded (it cannot be reused — its key would never match another
    request's complete block).
    """
    n_full = len(token_ids) // block_tokens
    hashes = []
    h = hashlib.sha256()
    for i in range(n_full):
        chunk = np.asarray(
            token_ids[i * block_tokens : (i + 1) * block_tokens], dtype=np.int64
        )
        h.update(chunk.tobytes())
        hashes.append(h.copy().hexdigest()[:32])
    return hashes


class _ChainHashCache:
    """Incremental chain-hash cache for repeated/extended token prefixes.

    Chain hashes commit to the whole prefix, so an unchanged prefix yields
    byte-identical hashes call after call. This caches the last prompt's
    full-block tokens, its chain list, and the live sha256 state after the
    final full block:

    - same prompt again        -> one array compare, zero hashing
    - the cached prompt's own  -> a slice of the cached chains
      prefix (fewer blocks)
    - extended prompt          -> hash only the new tail blocks
    - anything else            -> full recompute, cache replaced

    One entry only, held as ONE tuple read once and swapped atomically (the
    GIL makes the swap safe; sync lookups may run from concurrent threads):
    churn between two prompt families costs a recompute, never a wrong
    hash."""

    __slots__ = ("_state",)

    def __init__(self):
        # (block_tokens, full-block tokens ndarray, chain hashes, sha256
        # state after the last cached full block) — or None before first use.
        self._state: Optional[tuple] = None

    def hashes(self, token_ids: Sequence[int], block_tokens: int) -> List[str]:
        n_full = len(token_ids) // block_tokens
        if n_full == 0:
            return []
        # copy=True matters: for ndarray inputs asarray would keep a VIEW of
        # the caller's buffer, and an engine reusing that buffer for the next
        # prompt would mutate our cached tokens into falsely matching it —
        # returning the OLD prompt's hashes (another request's KV keys).
        toks = np.array(token_ids[: n_full * block_tokens], dtype=np.int64, copy=True)
        state = self._state  # one read: threads race the swap, never a tear
        if state is not None and state[0] == block_tokens:
            _, c_toks, c_hashes, c_h = state
            if toks.size <= c_toks.size and np.array_equal(
                toks, c_toks[: toks.size]
            ):
                # Repeat or prefix of the cached prompt: pure cache read
                # (keep the longer entry — serving its prefixes is free).
                return c_hashes[:n_full]
            if toks.size > c_toks.size and np.array_equal(
                toks[: c_toks.size], c_toks
            ):
                # Extension: hash only the new tail blocks.
                h = c_h.copy()
                hashes = list(c_hashes)
                for i in range(len(hashes), n_full):
                    h.update(toks[i * block_tokens : (i + 1) * block_tokens].tobytes())
                    hashes.append(h.copy().hexdigest()[:32])
                self._state = (block_tokens, toks, hashes, h)  # atomic swap
                return list(hashes)
        h = hashlib.sha256()
        hashes = []
        for i in range(n_full):
            h.update(toks[i * block_tokens : (i + 1) * block_tokens].tobytes())
            hashes.append(h.copy().hexdigest()[:32])
        self._state = (block_tokens, toks, hashes, h)  # atomic swap
        return list(hashes)


class FetchCoalescer:
    """Merge store reads issued in the same event-loop tick into ONE
    batched ``read_cache_async`` call.

    A wave of concurrent admissions starts one prefetch each; without
    coalescing every layer of every request is its own store round trip.
    All submitters target the same base pointer (one staging pool) and block
    size; the coalescer only merges, it never copies. Merges are sized to
    the connection's fan-out (``preferred_fanout_blocks()`` where the
    connection reports one) and partitioned by QoS class, so a BACKGROUND
    prefetch never drags a FOREGROUND admission into its class."""

    def __init__(self, conn, block_size: int, base_ptr: int,
                 max_merge_blocks: Optional[int] = None):
        self.conn = conn
        self.block_size = block_size
        self.base_ptr = base_ptr
        if max_merge_blocks is None:
            hint = getattr(conn, "preferred_fanout_blocks", None)
            max_merge_blocks = hint() if callable(hint) else 0
        self.max_merge_blocks = max_merge_blocks or 0  # 0 = unbounded
        self._pending: list = []
        self._flush_scheduled = False
        # Strong refs: the loop holds only weak refs to tasks.
        self._flush_tasks: set = set()
        self.calls = 0  # batched store calls issued
        self.submissions = 0  # logical submits merged into them
        self.max_batch = 0
        self.ring_windows = 0  # flushes that opened a ring batch window

    def submit(self, blocks, priority: int = 0) -> "asyncio.Future":
        """Queue one logical read (list of (key, offset-from-base) pairs);
        returns a future resolving when those bytes are staged. The
        submitter's active trace span is captured here and stamped
        ``coalesce`` when its merged call issues."""
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((blocks, fut, priority, tracing.active_span()))
        self.submissions += 1
        if not self._flush_scheduled:
            self._flush_scheduled = True
            task = asyncio.ensure_future(self._flush())
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_tasks.discard)
        return fut

    def _group(self, batch):
        """Pack this tick's submissions into merged-call groups of at most
        ``max_merge_blocks`` blocks, partitioned by QoS class first."""
        by_class: dict = {}
        for blocks, fut, priority, span in batch:
            by_class.setdefault(priority, []).append((blocks, fut, span))
        groups = []
        for priority, items in by_class.items():
            if not self.max_merge_blocks:
                groups.append((priority, items))
                continue
            cur, cur_blocks = [], 0
            for blocks, fut, span in items:
                if cur and cur_blocks + len(blocks) > self.max_merge_blocks:
                    groups.append((priority, cur))
                    cur, cur_blocks = [], 0
                cur.append((blocks, fut, span))
                cur_blocks += len(blocks)
            if cur:
                groups.append((priority, cur))
        return groups

    async def _flush(self):
        # One yield: everything enqueued this tick joins the batch.
        await asyncio.sleep(0)
        batch, self._pending = self._pending, []
        self._flush_scheduled = False
        if not batch:
            return
        # Open this tick's ring batch window where the connection has one,
        # so the merged calls publish as one multi-op batch slot.
        window = getattr(self.conn, "ring_batch_window", None)
        if callable(window):
            window()
            self.ring_windows += 1
        await asyncio.gather(*(self._issue(g, p) for p, g in self._group(batch)))

    async def _issue(self, batch, priority: int = 0):
        self.calls += 1
        self.max_batch = max(self.max_batch, len(batch))
        merged = [b for blocks, _, _ in batch for b in blocks]
        pri_kw = wire.qos_kwargs(self.conn, priority)
        # The merged wire op rides the first traced submitter's context;
        # override_span also clears a span this flush task inherited.
        lead_span = None
        for _, _, span in batch:
            if span is not None:
                span.stage("coalesce")
                span.annotate(coalesced_group=len(batch))
                if lead_span is None:
                    lead_span = span
        try:
            with tracing.override_span(lead_span):
                await self.conn.read_cache_async(merged, self.block_size, self.base_ptr,
                                                 **pri_kw)
        except Exception as e:
            # Per-submission retry isolates ONE evicted/pressured key from
            # its group-mates; a transport error fails the group fast.
            retryable = isinstance(e, (InfiniStoreKeyNotFound, InfiniStoreResourcePressure))
            if len(batch) == 1 or not retryable:
                for blocks, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(e)
                return
            for blocks, fut, span in batch:
                if fut.done():
                    continue
                self.calls += 1
                try:
                    with tracing.override_span(span):
                        await self.conn.read_cache_async(blocks, self.block_size,
                                                         self.base_ptr, **pri_kw)
                except Exception as e2:
                    fut.set_exception(e2)
                else:
                    fut.set_result(None)
            return
        for _, fut, _ in batch:
            if not fut.done():
                fut.set_result(None)


class KVConnector:
    """Bind one model's paged KV cache to a store connection.

    The engine calls, per request:
      - ``lookup(tokens)`` -> how many leading blocks are already cached
      - ``load(tokens, caches, block_ids)`` -> scatter those blocks into the
        engine's paged cache (skipping recompute of the shared prefix)
      - ``save(tokens, caches, block_ids)`` -> stream the request's blocks
        out, layer by layer, overlapping device-to-host copies with the
        network

    ``device``: where the engine's caches live (default ``"cuda"``; raises
    when no card is present). The staging pools (the reader's, and the
    prefetch arena ``start_fetch`` reserves from) are page-locked for a CUDA
    device; ``close()`` releases them and must come before the connection's
    own close.

    ``QOS_AWARE``: ``start_fetch`` takes the two-class priority kwarg
    (adapters gate forwarding on the attribute).

    ``ici``: an optional ``IciBlockTransfer`` over the devices this engine's
    caches live on. With it, ``handoff`` moves blocks device to device;
    without it the same call goes through the store. ``conn`` may be None
    with ``ici`` set: a pure-interconnect connector, with no staging pool and
    no store path."""

    QOS_AWARE = True

    def __init__(
        self,
        conn,
        spec: PagedKVCacheSpec,
        model_id: str,
        max_blocks: int,
        pool: Optional[HostStagingPool] = None,
        device="cuda",
        ici=None,
    ):
        self.device = _ext.resolve_device(device)
        self.conn = conn
        self.spec = spec
        self.model_id = model_id
        self.max_blocks = max_blocks
        self.ici = ici
        if conn is None and ici is not None:
            # Pure interconnect: no store data plane, so none of the staging
            # it would need.
            self.pool = pool
            self._writer = self._reader = None
        else:
            if pool is None:
                # 6 read-staging regions (K+V each): deep enough that network
                # fetches and uploads overlap several layers (layerwise.py
                # _LayerRegions adapts the pipeline depth to this size).
                pool = HostStagingPool(
                    12 * max_blocks * spec.block_nbytes, spec.block_nbytes, conn=conn,
                    device=self.device,
                )
            self.pool = pool
            self._writer = LayerwiseKVWriter(conn, pool, spec, max_blocks)
            self._reader = LayerwiseKVReader(conn, pool, spec, max_blocks)
        # Two-phase admission (start_fetch) reserves from its own arena: the
        # reader's _LayerRegions owns ``pool``'s layout outright. Lazy: only
        # engines on the pipelined path pay for it.
        self._prefetch_pool: Optional[HostStagingPool] = None
        self._coalescer: Optional[FetchCoalescer] = None
        # Chain-hash + sentinel-key caches: admission re-derives the same
        # prefix's keys on every lookup/load/save.
        self._chain_cache = _ChainHashCache()
        self._keys0_cache: Optional[Tuple[List[str], List[str]]] = None

    def close(self) -> None:
        """Release the staging pools' page locks (idempotent)."""
        if self.pool is not None:
            self.pool.close()
        if self._prefetch_pool is not None:
            self._prefetch_pool.close()

    # -- key scheme ----------------------------------------------------------

    def block_key(self, layer: int, kind: str, chain_hash: str) -> str:
        """Store key for one block: ``{model}/L{layer}/{k|v}/{chain_hash}``."""
        return f"{self.model_id}/L{layer}/{kind}/{chain_hash}"

    def _key_fn(self, chains: List[str]):
        def key_fn(layer: int, kind: str, block: int) -> str:
            return self.block_key(layer, kind, chains[block])

        return key_fn

    def _chains(self, token_ids: Sequence[int]) -> List[str]:
        """Chain hashes for this prompt's complete blocks, served from the
        incremental cache."""
        return self._chain_cache.hashes(token_ids, self.spec.block_tokens)

    def _sentinel_keys(self, chains: List[str]) -> List[str]:
        """Layer-0 K keys for a chain (the whole-block presence sentinels
        lookups send). Cached: because chain hash i commits to the entire
        prefix, a match on length + final hash proves the whole key list is
        the cached one, and a shorter chain is served as a slice of a cached
        longer one."""
        cached = self._keys0_cache
        n = len(chains)
        if cached is not None:
            c_chains, c_keys = cached
            if len(c_chains) >= n and c_chains[n - 1] == chains[-1]:
                return c_keys[:n]
        keys = [self.block_key(0, "k", c) for c in chains]
        self._keys0_cache = (list(chains), keys)
        return keys

    def manifest(self, token_ids, n_blocks: Optional[int] = None):
        """Every store key this connector would hold for the prompt's first
        ``n_blocks`` complete blocks (default: all), as size-grouped
        ``[(block_nbytes, [key, ...])]``. Sentinel ordering: the layer-0 K
        key of each block (what ``lookup`` probes) is LAST in its group, so
        a batched copy that dies mid-stream never publishes a sentinel for
        an incompletely copied block."""
        chains = self._chains(token_ids)
        if n_blocks is not None:
            chains = chains[:n_blocks]
        keys = [
            self.block_key(layer, kind, c)
            for layer in range(self.spec.num_layers)
            for kind in ("k", "v")
            for c in chains
            if (layer, kind) != (0, "k")
        ] + [self.block_key(0, "k", c) for c in chains]
        return [(self.spec.block_nbytes, keys)] if keys else []

    # -- engine surface ------------------------------------------------------

    def lookup(self, token_ids: Sequence[int]) -> int:
        """Number of leading blocks of this prompt already in the store.

        One control round-trip: the layer-0 K keys stand in for the whole
        block (the writer commits layer 0 last, so a present sentinel means
        every layer is present), and the store's binary-search longest-prefix
        match does the rest.

        Only a semantic no-match maps to 0. A dead store, a timeout, or a
        protocol error raises — the engine must see the difference between
        "not cached" and "store unreachable"."""
        return self._lookup_chains(self._chains(token_ids))

    def _lookup_chains(self, chains: List[str]) -> int:
        if not chains:
            return 0
        keys = self._sentinel_keys(chains)
        try:
            # The blocking probe RTT: async callers hop it through an
            # executor (load()'s to_thread); sync lookup() owns the cost.
            return self.conn.get_match_last_index(keys) + 1  # its: allow[ITS-L001]
        except InfiniStoreNoMatch:
            return 0

    async def save(
        self, token_ids, caches, block_ids: np.ndarray, first_block: int = 0,
        priority: int = wire.PRIORITY_BACKGROUND,
    ) -> int:
        """Stream the request's KV blocks to the store. ``block_ids[i]`` is
        the engine's physical block holding logical block ``first_block + i``
        of this prompt. Returns blocks written (K+V across layers).

        Saves are BACKGROUND class by default (docs/qos.md): a prefill save
        is never decode-blocking. ``first_block`` serves sharded producers:
        each passes the FULL token list (chain hashes commit to the whole
        prefix) but saves just its logical span."""
        chains = self._chains(token_ids)
        if first_block < 0 or first_block > len(chains):
            raise ValueError(
                f"first_block={first_block} outside the prompt's "
                f"{len(chains)} complete blocks"
            )
        chains = chains[first_block:]
        n = min(len(chains), len(block_ids))
        if n == 0:
            return 0
        return await self._writer.write(
            caches, np.asarray(block_ids[:n]), self._key_fn(chains),
            priority=priority,
        )

    async def load(
        self, token_ids, caches, block_ids: np.ndarray, first_block: int = 0,
        on_layer=None,
    ):
        """Fetch this prompt's cached prefix into the engine's paged cache.

        Fetches up to ``lookup(tokens) - first_block`` blocks (capped by
        len(block_ids)) and scatters them in place; returns (caches,
        blocks_loaded). ``first_block`` skips a prefix the engine already
        holds: ``block_ids[i]`` then receives logical block ``first_block +
        i`` — symmetric with ``save``'s ``first_block``.

        On a mid-read store miss the returned caches are the partially
        updated list (``PartialReadError.caches``); use the returned list.

        ``on_layer(layer, (k, v))``: optional per-layer progress hook (layers
        complete in order — see LayerwiseKVReader.read)."""
        chains = self._chains(token_ids)
        if first_block < 0 or first_block > len(chains):
            raise ValueError(
                f"first_block={first_block} outside the prompt's "
                f"{len(chains)} complete blocks"
            )
        # The prefix lookup is a blocking store round trip: hop it through
        # the default executor so it does not stall the event loop.
        hit = await asyncio.to_thread(self._lookup_chains, chains)
        n = min(hit - first_block, len(block_ids))
        if n <= 0:
            return list(caches), 0
        # Trace: the cached prefix's store streaming begins here (the probe
        # above is control-plane; fetch_start marks the first data-plane leg).
        tspan = tracing.active_span()
        if tspan is not None:
            tspan.stage("fetch_start")
            tspan.annotate(hit_blocks=hit, fetch_blocks=n)
        span = chains[first_block : first_block + n]
        try:
            out = await self._reader.read(
                caches, np.asarray(block_ids[:n]), self._key_fn(span),
                on_layer=on_layer,
            )
        except PartialReadError as e:
            if isinstance(
                e.cause, (InfiniStoreKeyNotFound, InfiniStoreResourcePressure)
            ):
                # KeyNotFound: blocks raced away between lookup and read.
                # ResourcePressure: store RAM too pressured to serve right
                # now. Cache semantics either way — the engine recomputes;
                # transport errors still propagate.
                if isinstance(e.cause, InfiniStoreColdTier):
                    # The typed 512: cold BUT ALIVE — a tier demotion hit,
                    # not a miss (docs/tiering.md).
                    tiering_note_demotion_hit()
                return e.caches, 0
            raise
        return out, n

    def start_fetch(
        self,
        token_ids,
        first_block: int = 0,
        limit_blocks: Optional[int] = None,
        prefetch_pool: Optional[HostStagingPool] = None,
        priority: int = wire.PRIORITY_FOREGROUND,
        known_hit: Optional[int] = None,
        retry_missing_s: float = 0.0,
        retry_interval_s: float = 0.002,
        fetch_gate=None,
    ) -> LayerwisePrefetch:
        """Begin the GATE-FREE half of a load: probe the store (one control
        round trip, skipped when ``known_hit`` is given) and start streaming
        the hit prefix's layers into reserved host staging regions, with no
        device work; callable before the engine has allocated blocks. The
        returned :class:`~.cuda.layerwise.LayerwisePrefetch` carries
        ``hit_blocks`` and ``n_blocks``; ``install(caches, block_ids)`` is
        the short exclusive phase with ``load``'s semantics, ``discard()``
        cancels cleanly.

        Concurrent admissions' fetches coalesce into shared batched store
        reads (:class:`FetchCoalescer`) unless a ``prefetch_pool`` of the
        caller's is given. ``priority``: QoS class of the fetch's reads.

        ``retry_missing_s``: the handoff's read-racing-write mode
        (``disagg.py``): a decode engine fetching a prefix the prefill engine
        is still shipping sees KeyNotFound for layers not published yet, and
        with a nonzero deadline the prefetch re-probes them every
        ``retry_interval_s`` instead of failing, so per-layer installs
        (``install_layer``) ride out the race. Zero (the default) keeps
        strict cache semantics. ``fetch_gate`` (``async fetch_gate(layer)``)
        is the announce-driven variant: layer ``l``'s read waits for the
        producer's announcement. Both modes bypass the coalescer (each
        layer's reads go direct), so one stalled layer never holds up merged
        group-mates.

        Raises :class:`~.cuda.staging.StagingPoolExhausted` (carrying the
        probe's ``hit_blocks``) when the arena cannot hold another pipeline;
        callers treat that as backpressure and fall back to ``load``. Must
        be called from the running event loop that will install or discard;
        the inline probe blocks that loop for one store round trip, so
        async callers use :meth:`start_fetch_async`."""
        chains = self._chains(token_ids)
        if first_block < 0 or first_block > len(chains):
            raise ValueError(
                f"first_block={first_block} outside the prompt's "
                f"{len(chains)} complete blocks"
            )
        hit = self._lookup_chains(chains) if known_hit is None else known_hit
        n = min(max(0, hit - first_block), self.max_blocks)
        if limit_blocks is not None:
            n = min(n, limit_blocks)
        pool = prefetch_pool or self._ensure_prefetch_pool()
        tspan = tracing.active_span()
        if tspan is not None and n > 0:
            tspan.stage("fetch_start")
            tspan.annotate(hit_blocks=hit, fetch_blocks=n)
        span = chains[first_block : first_block + n]
        # Mutable class cell so promote() upgrades LATER submissions on the
        # coalescer path too (the closure reads it per call).
        pri_cell = {"value": priority}
        submit = None
        if prefetch_pool is None and retry_missing_s <= 0 and fetch_gate is None:
            coalescer = self._ensure_coalescer(pool)
            submit = lambda blocks: coalescer.submit(blocks, priority=pri_cell["value"])  # noqa: E731
        try:
            handle = LayerwisePrefetch(
                self.conn, pool, self.spec, self._key_fn(span), n, self.spec.num_layers,
                submit=submit, priority=priority, priority_cell=pri_cell,
                retry_missing_s=retry_missing_s, retry_interval_s=retry_interval_s,
                fetch_gate=fetch_gate,
            )
        except StagingPoolExhausted as e:
            # The probe already ran: hand its answer to the fallback so a
            # backpressured admission does not pay the round trip twice.
            e.hit_blocks = hit
            raise
        handle.hit_blocks = hit
        return handle

    async def start_fetch_async(
        self,
        token_ids,
        first_block: int = 0,
        limit_blocks: Optional[int] = None,
        prefetch_pool: Optional[HostStagingPool] = None,
        priority: int = wire.PRIORITY_FOREGROUND,
        known_hit: Optional[int] = None,
        retry_missing_s: float = 0.0,
        retry_interval_s: float = 0.002,
        fetch_gate=None,
    ) -> LayerwisePrefetch:
        """:meth:`start_fetch` for event-loop callers: the probe runs in the
        default executor, then the handle is built on the loop (its fetch
        futures need the running loop). ``known_hit`` skips the probe: the
        overlapped handoff passes the block count the producer announced,
        because a probe during an in-flight handoff sees only the layers
        published so far."""
        if known_hit is None:
            known_hit = await asyncio.to_thread(self._lookup_chains, self._chains(token_ids))
        return self.start_fetch(
            token_ids, first_block=first_block, limit_blocks=limit_blocks,
            prefetch_pool=prefetch_pool, priority=priority, known_hit=known_hit,
            retry_missing_s=retry_missing_s, retry_interval_s=retry_interval_s,
            fetch_gate=fetch_gate,
        )

    def _ensure_prefetch_pool(self) -> HostStagingPool:
        if self._prefetch_pool is None:
            # ~4 full-depth pipelines (capped at 8 regions each, matching
            # LayerwisePrefetch's default): enough for a concurrent
            # admission wave; an over-wave falls back to the gated load.
            regions = min(self.spec.num_layers, 8)
            nbytes = 4 * regions * 2 * self.max_blocks * self.spec.block_nbytes
            self._prefetch_pool = HostStagingPool(
                nbytes, self.spec.block_nbytes, conn=self.conn, device=self.device,
            )
        return self._prefetch_pool

    def _ensure_coalescer(self, pool: HostStagingPool) -> FetchCoalescer:
        if self._coalescer is None or self._coalescer.base_ptr != pool.base_ptr:
            self._coalescer = FetchCoalescer(self.conn, self.spec.block_nbytes, pool.base_ptr)
        return self._coalescer

    def stage_layer_save(
        self, token_ids, layer: int, kv_pair, block_ids: np.ndarray,
        first_block: int = 0, priority: int = wire.PRIORITY_BACKGROUND,
    ):
        """Stage ONE layer's computed blocks for saving; returns ``ship``,
        an async callable that does the network puts (2*n blocks written).

        The gathers (K1 on CUDA) and the device-to-host copy start NOW, on
        the caller's thread, so the bytes are taken before later compute can
        change the cache; ``ship()`` only awaits (the copy's wait runs in an
        executor so it never stalls the caller's event loop). This is the
        layer-granular half of ``save()`` for engines that stream saves as
        each layer's forward completes: such callers MUST ship layer 0
        last, because its keys are the whole-block presence sentinel
        (``lookup``). Whole-request saves use ``save()``, whose writer
        enforces that order itself.

        ``priority``: QoS class of the puts (docs/qos.md); layer-streamed
        saves default to BACKGROUND. The caller's active trace span is
        captured now and rides the ship, which stamps ``submit`` when its
        puts issue."""
        chains = self._chains(token_ids)
        if first_block < 0 or first_block > len(chains):
            # Same bounds contract as save()/load(): out of range would
            # silently slice to an empty chain list and a no-op ship.
            raise ValueError(
                f"first_block={first_block} outside the prompt's "
                f"{len(chains)} complete blocks"
            )
        chains = chains[first_block:]
        n = min(len(chains), len(block_ids))
        if n == 0:
            async def noop() -> int:
                return 0

            return noop
        k_cache, v_cache = kv_pair
        bn = self.spec.block_nbytes
        ids = torch.as_tensor(np.asarray(block_ids[:n]), dtype=torch.int32,
                              device=k_cache.device)
        # One packed [K blocks | V blocks] tensor from one gather -> one D2H
        # copy (the writer's shape, cuda/layerwise.py).
        tr = self.pool.stage_out([gather_blocks_many((k_cache, v_cache), ids)])
        keys_k = [(self.block_key(layer, "k", chains[i]), i * bn) for i in range(n)]
        keys_v = [(self.block_key(layer, "v", chains[i]), (n + i) * bn) for i in range(n)]
        pri_kw = wire.qos_kwargs(self.conn, priority)
        # Capture the request's trace context HERE: ship() typically runs as
        # a free-floating task whose context is whatever scheduled it.
        span = tracing.active_span()

        async def ship() -> int:
            loop = asyncio.get_running_loop()
            (kv_host,) = await loop.run_in_executor(None, tr.wait)
            base = kv_host.ctypes.data
            if span is not None:
                span.stage("submit")
                span.annotate(handoff_layer=layer, handoff_blocks=2 * n)
            try:
                with tracing.override_span(span):
                    await asyncio.gather(
                        self.conn.write_cache_async(keys_k, bn, base, **pri_kw),
                        self.conn.write_cache_async(keys_v, bn, base, **pri_kw),
                    )
            finally:
                tr.release()
            return 2 * n

        return ship

    async def handoff(
        self,
        token_ids,
        caches,
        src_block_ids: np.ndarray,
        dst_block_ids: np.ndarray,
        src: Optional[int] = None,
        dst: Optional[int] = None,
    ):
        """Move a request's KV blocks from a producer to a consumer.

        With an ``IciBlockTransfer`` bound (``ici``) and ``src``/``dst``
        given: device to device, no host, no store. ``caches`` are then per
        layer ``(K, V)``, each a list of per-shard ``[num_blocks, *block]``
        tensors (shard ``i`` on the transfer's ``mesh[i]``); a uniform list
        moves in one ``handoff_layers`` (one K1 launch, one copy, one K2
        launch), a ragged one in one ``handoff_kv`` per layer. Only shard
        ``dst``'s caches change, in place.

        Otherwise through the store: save the blocks under the request's
        chain keys at FOREGROUND priority (the consumer loads the same blocks
        next), then load them into ``dst_block_ids``. The cross-process flow
        runs the save on the producer and the load on the consumer; calling
        handoff in one process does both. ``caches`` are per-layer
        ``[num_blocks, *block]`` tensors, updated in place. A pure
        interconnect connector (``conn`` None) has no store to go through and
        raises without ``src``/``dst``.

        Both transports move the request's complete token blocks only (an
        incomplete tail block has no chain key, so the store could not carry
        it). Returns (caches, blocks moved)."""
        chains = self._chains(token_ids)
        n = min(len(src_block_ids), len(dst_block_ids), len(chains))
        if n == 0:
            return list(caches), 0
        if self.ici is not None and src is not None and dst is not None:
            src_ids, dst_ids = src_block_ids[:n], dst_block_ids[:n]
            flat = [c for kv in caches for c in kv]
            uniform = all(
                len(c) == len(flat[0]) and all(
                    t.shape == flat[0][0].shape and t.dtype == flat[0][0].dtype for t in c)
                for c in flat
            )
            if uniform:
                out = self.ici.handoff_layers(list(caches), src_ids, dst_ids, src, dst)
            else:
                # Ragged layers (fewer blocks, another dtype) cannot share one
                # packed buffer: one K + V handoff per layer.
                out = [self.ici.handoff_kv(k, v, src_ids, dst_ids, src, dst)
                       for k, v in caches]
            return out, n
        if self.ici is not None and self.conn is None:
            raise ValueError(
                "pure interconnect connector: handoff needs src and dst shard "
                "indices (no store connection to go through)"
            )
        # The store path gathers along axis 0 = blocks, so a cache with an
        # extra leading (device) axis would ship wrong bytes under valid
        # keys: reject it.
        block_shape = tuple(self.spec.block_shape)
        for k_cache, v_cache in caches:
            for c in (k_cache, v_cache):
                if not isinstance(c, torch.Tensor) or c.dim() != 1 + len(block_shape) \
                        or tuple(c.shape[1:]) != block_shape:
                    raise ValueError(
                        "handoff through the store needs per-layer caches of shape "
                        f"[num_blocks, {', '.join(map(str, block_shape))}]; "
                        f"got {tuple(c.shape) if isinstance(c, torch.Tensor) else type(c)}"
                    )
        await self.save(
            token_ids, caches, np.asarray(src_block_ids)[:n],
            priority=wire.PRIORITY_FOREGROUND,
        )
        return await self.load(token_ids, caches, np.asarray(dst_block_ids)[:n])

    def get_stats(self) -> dict:
        """The store connection's per-op stats snapshot."""
        return self.conn.get_stats()

    def drop(self, token_ids) -> int:
        """Remove this prompt's blocks from the store (all layers). Returns
        the number of store keys deleted."""
        chains = self._chains(token_ids)
        keys = [
            self.block_key(layer, kind, c)
            for layer in range(self.spec.num_layers)
            for kind in ("k", "v")
            for c in chains
        ]
        return self.conn.delete_keys(keys) if keys else 0
