"""Layer-wise streaming of paged KV blocks between device memory and the
store (port of ``infinistore_tpu/tpu/layerwise.py``: the writer, the reader
and the two-phase ``LayerwisePrefetch``; the prefetch's handoff modes,
``retry_missing_s``/``fetch_gate`` and the per-layer ``install_layer``/
``layer_ready``, serve only the disaggregation path and are not ported yet).

The store's latency trick: stream the KV cache layer by layer so network
transfer overlaps per-layer work. Device-to-host copies (on a side stream)
and network puts (up to ``depth`` layers in flight) are pipelined, and the
writer ships directly from the pinned buffers the copies land in.

Key naming follows the hash-chain convention: one key per (request-chain
hash, layer, k/v, block index), so ``get_match_last_index`` gives
longest-prefix reuse across requests.
"""

import asyncio
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import wire
from ..lib import InfiniStoreException, InfiniStoreKeyNotFound, InfiniStoreResourcePressure
from .paged import PagedKVCacheSpec, gather_blocks_many, scatter_blocks_many
from .staging import HostStagingPool, StagingPoolExhausted

KeyFn = Callable[[int, str, int], str]  # (layer, "k"|"v", block_index) -> key


class PartialReadError(InfiniStoreException):
    """A layerwise read failed mid-pipeline.

    ``caches`` is the ONLY valid cache list after this error: layers before
    the failure were scattered in place, layers at/after it are the
    caller's untouched tensors. ``cause`` is the underlying store error
    (e.g. InfiniStoreKeyNotFound when blocks raced away between lookup and
    read). Callers that swallow the failure as a cache miss must hand
    ``caches`` — never their original list — back to the engine."""

    def __init__(self, caches, cause: BaseException):
        super().__init__(f"layerwise read failed mid-pipeline: {cause!r}")
        self.caches = caches
        self.cause = cause


def kv_block_key(model: str, chain_hash: str, layer: int, kind: str, block: int) -> str:
    """Default key scheme: model/chain-hash/layer/k|v/block."""
    return f"{model}/{chain_hash}/L{layer}/{kind}{block}"


def _block_ids_on(block_ids, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(block_ids, dtype=torch.int32, device=device)


class _LayerRegions:
    """Read-staging layout: region r holds one layer's K blocks immediately
    followed by its V blocks — a single contiguous span, so the whole layer
    uploads to the device as ONE transfer. The region count adapts to the
    pool size (>= 2 — double buffering — up to 8), deepening the fetch/upload
    pipeline when the pool affords it."""

    def __init__(self, pool: HostStagingPool, spec: PagedKVCacheSpec, max_blocks: int):
        if spec.block_nbytes > pool.block_size:
            raise ValueError(
                f"staging pool block_size {pool.block_size} < KV block "
                f"{spec.block_nbytes}"
            )
        self.pool = pool
        self.spec = spec
        self.max_blocks = max_blocks
        # count regions x (K + V) x max_blocks slots.
        self.count = min(8, pool.num_slots // (2 * max_blocks))
        if self.count < 2:
            raise ValueError(
                f"staging pool too small: need {4 * max_blocks} slots of "
                f"{pool.block_size}B, have {pool.num_slots}"
            )

    def base_offset(self, region: int) -> int:
        """Byte offset of a region's contiguous K+V span."""
        return self.pool.slot_offset(region * 2 * self.max_blocks)

    def kv_view(self, region: int, n: int, nbytes_per_block: int):
        """Zero-copy view of the region's packed K+V span (2*n blocks)."""
        off = self.base_offset(region)
        return self.pool.buf[off : off + 2 * n * nbytes_per_block]


class LayerwiseKVWriter:
    """Stream a request's KV blocks to the store, one layer at a time.

    Pipeline per layer: gather the blocks from the paged cache (kernel K1
    on CUDA), pack K and V into one tensor, start ONE device-to-host copy,
    and ship previous layers' host buffers on the network concurrently — up
    to ``depth`` layer-groups of puts in flight. Puts go straight from the
    pinned copy (registered for the op's lifetime), so the only host copy is
    the one into the server's pool."""

    def __init__(self, conn, pool: HostStagingPool, spec: PagedKVCacheSpec,
                 max_blocks: int, depth: int = 2, d2h_window: int = 4):
        if depth < 1 or d2h_window < 1:
            raise ValueError("depth and d2h_window must be >= 1")
        self.conn = conn
        self.spec = spec
        # The writer ships straight from the device-to-host buffers — the
        # pool provides the connection to register them with and the copy
        # stream; no slots are consumed.
        self.pool = pool
        self.max_blocks = max_blocks
        self.depth = depth
        # Layers of device-to-host copies kept in flight, at a device-memory
        # cost of 2 x n x block_nbytes per window entry.
        self.d2h_window = d2h_window

    async def write(
        self,
        caches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        block_ids: np.ndarray,
        key_fn: KeyFn,
        priority: int = wire.PRIORITY_FOREGROUND,
    ) -> int:
        """Returns total blocks written (K+V across layers). ``priority``:
        QoS class for the network puts — connectors tag whole-request saves
        BACKGROUND (prefill saves must not delay decode-blocking reads;
        docs/qos.md) while the default stays untagged."""
        n = len(block_ids)
        if n == 0:
            return 0
        if n > self.max_blocks:
            raise ValueError(f"{n} blocks > writer capacity {self.max_blocks}")
        ids_dev = _block_ids_on(block_ids, caches[0][0].device)
        pool = self.pool
        bn = self.spec.block_nbytes
        # (futures, registered transfer, blocks count) groups in flight.
        inflight: deque = deque()
        total = 0

        async def drain_one() -> int:
            futs, tr, count = inflight.popleft()
            # Let BOTH puts settle before releasing the host buffers — a
            # failed K-batch must not free memory the V-batch's writev is
            # still streaming from — then surface the first failure.
            results = await asyncio.gather(*futs, return_exceptions=True)
            tr.release()
            for r in results:
                if isinstance(r, BaseException):
                    raise r
            return count

        # Layer 0 is written LAST: connectors use a block's layer-0 K key as
        # the presence sentinel for the whole block (one prefix-match probe
        # instead of layers x 2), so it must commit only after every deeper
        # layer did — a half-saved block then reads as absent, never as a
        # false hit.
        order = list(range(1, len(caches))) + [0] if len(caches) > 1 else [0]
        # Stage ahead: gather + start the device-to-host copy for up to
        # d2h_window layers before consuming the oldest.
        staged: deque = deque()
        todo = iter(enumerate(order))

        def top_up():
            while len(staged) < self.d2h_window:
                nxt = next(todo, None)
                if nxt is None:
                    return
                pos, layer = nxt
                # K blocks then V blocks packed into ONE tensor by one
                # gather -> one device-to-host copy per layer.
                staged.append((pos, layer, pool.stage_out([
                    gather_blocks_many(caches[layer], ids_dev)
                ])))

        try:
            top_up()
            while staged:
                pos, layer, tr = staged.popleft()
                # Keep at most depth-1 older put groups while this copy lands.
                while len(inflight) >= self.depth:
                    total += await drain_one()
                if pos == len(order) - 1:
                    # Layer-0-last barrier: every deeper layer's put must have
                    # completed (= committed) before the sentinel ships.
                    while inflight:
                        total += await drain_one()
                (kv_host,) = tr.wait()  # registers the packed buffer
                base = kv_host.ctypes.data
                pri_kw = wire.qos_kwargs(self.conn, priority)
                futs = (
                    asyncio.ensure_future(self.conn.write_cache_async(
                        [(key_fn(layer, "k", i), i * bn) for i in range(n)],
                        bn, base, **pri_kw)),
                    asyncio.ensure_future(self.conn.write_cache_async(
                        [(key_fn(layer, "v", i), i * bn) for i in range(n)],
                        bn, base + n * bn, **pri_kw)),
                )
                inflight.append((futs, tr, 2 * n))
                top_up()  # refill the copy pipeline before blocking again
            while inflight:
                total += await drain_one()
        finally:
            # On error, still wait for anything in flight before dropping the
            # host buffers — the native reactor may be mid-writev on them
            # (a dead connection fails these futures promptly via fail_all).
            while inflight:
                futs, tr, _ = inflight.popleft()
                try:
                    await asyncio.gather(*futs, return_exceptions=True)
                finally:
                    tr.release()
        return total


class LayerwiseKVReader:
    """Fetch a request's KV blocks from the store layer by layer, scattering
    into the paged cache; the network get of layer l+1 overlaps the upload
    + scatter of layer l. Reads land in the pool — same-host that is the
    server-mapped segment (one-RTT GetInto) — and the upload reads straight
    from it."""

    def __init__(self, conn, pool: HostStagingPool, spec: PagedKVCacheSpec,
                 max_blocks: int):
        self.conn = conn
        self.spec = spec
        self.regions = _LayerRegions(pool, spec, max_blocks)

    async def read(
        self,
        caches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        block_ids: np.ndarray,
        key_fn: KeyFn,
        on_layer=None,
        priority: int = wire.PRIORITY_FOREGROUND,
    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Returns the per-layer (K, V) cache list, updated in place.

        ``priority``: QoS class of the per-layer store reads
        (wire.PRIORITY_*); the one-phase load is decode-blocking, so
        FOREGROUND is the default (docs/qos.md).

        ``on_layer(layer, (k, v))``: optional hook invoked as each layer's
        scatter is ISSUED (layers complete in order 0..L-1) with that
        layer's cache tensors."""
        n = len(block_ids)
        num_layers = len(caches)
        if n == 0:
            return list(caches)
        if n > self.regions.max_blocks:
            raise ValueError(f"{n} blocks > reader capacity {self.regions.max_blocks}")
        device = caches[0][0].device
        ids_dev = _block_ids_on(block_ids, device)
        pool = self.regions.pool
        bn = self.spec.block_nbytes

        def fetch(layer: int):
            # K blocks then V blocks packed into one contiguous region span,
            # so the layer later uploads as a single device transfer.
            base = self.regions.base_offset(layer % self.regions.count)
            blocks = [
                (key_fn(layer, "k", i), base + i * bn) for i in range(n)
            ] + [
                (key_fn(layer, "v", i), base + (n + i) * bn) for i in range(n)
            ]
            return asyncio.ensure_future(
                self.conn.read_cache_async(
                    blocks, bn, pool.base_ptr,
                    **wire.qos_kwargs(self.conn, priority),
                )
            )

        # Pipeline: with R regions, keep W = R-2 network fetches in flight
        # ahead of device consumption. A region is reused only once its
        # previous occupant's UPLOAD has landed — never its scatters, which
        # queue on the device and must not gate the host loop. On CUDA that
        # is the event recorded after the occupant's host-to-device copy. On
        # CPU the "upload" is ``torch.from_numpy``, which aliases the region,
        # but the scatter (``index_copy_``) copies eagerly before returning,
        # so the region is already free and there is nothing to wait for.
        R = self.regions.count
        W = max(1, R - 2)
        out: List[Tuple[torch.Tensor, torch.Tensor]] = list(caches)
        fetches = {}
        uploads = {}  # layer -> CUDA event after its upload (None on CPU)

        def start(f: int):
            if f < num_layers and f not in fetches:
                occupant = f - R
                if occupant >= 0:
                    done = uploads.pop(occupant)
                    if done is not None:
                        done.synchronize()
                fetches[f] = fetch(f)

        try:
            for f in range(min(W, num_layers)):
                start(f)
            for layer in range(num_layers):
                await fetches.pop(layer)
                region = layer % R
                # Bytes arrive as uint8; view them as the cache dtype in
                # torch (numpy has no bfloat16).
                kv_host = (
                    torch.from_numpy(self.regions.kv_view(region, n, bn))
                    .view(self.spec.dtype)
                    .reshape((2 * n, *self.spec.block_shape))
                )
                if device.type == "cuda":
                    # ONE upload per layer (K and V ride together).
                    kv_dev = kv_host.to(device, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(device))
                else:
                    kv_dev, done = kv_host, None
                uploads[layer] = done
                out[layer] = tuple(scatter_blocks_many(out[layer], ids_dev, kv_dev))
                if on_layer is not None:
                    on_layer(layer, out[layer])
                start(layer + W)
        except Exception as exc:
            # Layers before the failure were written in place; ship the list
            # with the error so recovery paths hand back the live tensors.
            raise PartialReadError(out, exc) from exc
        finally:
            # Failure drain: pending fetches would otherwise keep writing
            # into regions a subsequent read() on this pool is using, and the
            # pool may be reused as soon as we return, so every staged byte
            # must have been consumed by the device.
            if fetches:
                await asyncio.gather(*fetches.values(), return_exceptions=True)
            for done in uploads.values():
                if done is not None:
                    done.synchronize()
        return out


class PrefetchDiscarded(RuntimeError):
    """install() was called on a prefetch that was discarded (or the
    prefetch was discarded out from under a waiter)."""


class LayerwisePrefetch:
    """The two-phase split of :class:`LayerwiseKVReader`: a gate-free FETCH
    (store -> reserved host staging regions, running from construction) and
    a short device INSTALL (host -> device upload + K2 scatter) that the
    engine runs under its exclusive cache discipline. The block table is
    only needed at :meth:`install`, so the fetch can start at admission,
    before the engine has allocated device blocks.

    Layout: ``regions`` staging regions, each one contiguous packed
    [K blocks | V blocks] span, reserved from the pool as ONE lease. Layer
    L fetches into region ``L % regions``; with fewer regions than layers a
    region is refilled only after :meth:`install` consumed its occupant.
    Consumed means: on CUDA, the occupant's host-to-device copy has landed
    (a CUDA event, waited for off the event loop); on CPU, the upload is a
    ``torch.from_numpy`` view that the scatter (``index_copy_``) copies from
    before it returns, so the region is free once the scatter is issued.

    :meth:`discard` is safe at any point before install: in-flight store
    reads are drained (they write into leased memory), then the lease is
    released and the staged bytes count as waste (``wasted_blocks``).

    Single event loop: construct, install and discard from the same running
    loop (the fetch tasks and consumed-events bind to it)."""

    def __init__(
        self,
        conn,
        pool: HostStagingPool,
        spec: PagedKVCacheSpec,
        key_fn: KeyFn,
        n_blocks: int,
        num_layers: int,
        regions: Optional[int] = None,
        submit=None,
        priority: int = wire.PRIORITY_FOREGROUND,
        priority_cell: Optional[dict] = None,
    ):
        """``submit(blocks)``: optional override for the store read (the
        connector's fetch coalescer); default is a direct
        ``read_cache_async`` at ``priority``. ``priority_cell``: the shared
        QoS cell a ``submit`` override reads, so :meth:`promote` reaches it.
        Raises :class:`~.staging.StagingPoolExhausted` when the pool cannot
        hold even a double-buffered pipeline."""
        self.conn = conn
        self.pool = pool
        self.spec = spec
        self.n_blocks = n_blocks
        self.num_layers = num_layers
        self.hit_blocks = n_blocks  # overridden by the connector's lookup
        # QoS class cell read per submission, so promote() reaches fetches
        # not issued yet.
        self._pri_cell = priority_cell if priority_cell is not None else {"value": priority}
        self.blocks_fetched = 0  # K+V blocks landed in staging
        self.blocks_installed = 0  # K+V blocks scattered to the device
        self.fetch_started_s = time.perf_counter()
        self.fetch_finished_s: Optional[float] = None
        self._cancelled = False
        self._discarded = False
        self._error: Optional[BaseException] = None  # first store failure
        self._lease = None
        if n_blocks == 0:
            self.regions = 0
            self._staged: List[asyncio.Future] = []
            self._consumed: List[asyncio.Event] = []
            self._drained = asyncio.Event()
            self._drained.set()
            self.fetch_finished_s = self.fetch_started_s
            return
        bn = spec.block_nbytes
        # Region stride in whole pool slots (a region is one contiguous
        # [K | V] span of 2 * n_blocks KV blocks).
        self._region_bytes = 2 * n_blocks * bn
        slots_per_region = -(-self._region_bytes // pool.block_size)
        self._region_stride = slots_per_region * pool.block_size
        floor = 1 if num_layers == 1 else 2
        want = min(num_layers, 8) if regions is None else regions
        want = max(floor, min(want, num_layers))
        # Degrade to a shallower pipeline before giving up: fewer regions
        # only means more install/fetch handoffs, not less data.
        for r in range(want, floor - 1, -1):
            try:
                self._lease = pool.reserve(r * slots_per_region)
                self.regions = r
                break
            except StagingPoolExhausted:
                if r == floor:
                    raise
        pri_cell = self._pri_cell
        self._submit = submit or (
            lambda blocks: conn.read_cache_async(
                blocks, bn, pool.base_ptr, **wire.qos_kwargs(conn, pri_cell["value"])
            )
        )
        loop = asyncio.get_running_loop()
        self._staged = [loop.create_future() for _ in range(num_layers)]
        for fut in self._staged:
            # A prefetch discarded before install must not log "exception
            # was never retrieved".
            fut.add_done_callback(lambda f: f.exception() if not f.cancelled() else None)
        self._consumed = [asyncio.Event() for _ in range(num_layers)]
        self._installing: set = set()  # layers whose bytes the device reads
        self._drained = asyncio.Event()
        self._key_fn = key_fn
        self._tasks = [asyncio.ensure_future(self._fetch_layer(layer))
                       for layer in range(num_layers)]
        self._live = len(self._tasks)
        for t in self._tasks:
            t.add_done_callback(self._on_task_done)

    # -- fetch phase (gate-free) --------------------------------------------

    def _region_offset(self, layer: int) -> int:
        return self._lease.offset + (layer % self.regions) * self._region_stride

    async def _fetch_layer(self, layer: int):
        if layer >= self.regions:
            # Double buffering: refill a region only once install consumed
            # (or discard wrote off) its previous occupant.
            await self._consumed[layer - self.regions].wait()
        if self._cancelled:
            return
        n, bn = self.n_blocks, self.spec.block_nbytes
        base = self._region_offset(layer)
        blocks = [(self._key_fn(layer, "k", i), base + i * bn) for i in range(n)] + [
            (self._key_fn(layer, "v", i), base + (n + i) * bn) for i in range(n)
        ]
        try:
            await self._submit(blocks)
        except asyncio.CancelledError:
            self._cancel_rest()
            raise
        except BaseException as e:
            if self._error is None:
                self._error = e
            if not self._staged[layer].done():
                self._staged[layer].set_exception(e)
            # One failing layer dooms the whole prefix (a partial prefix has
            # no value): stop refilling regions.
            self._cancel_rest()
            return
        self.blocks_fetched += 2 * n
        if not self._staged[layer].done():
            self._staged[layer].set_result(layer % self.regions)
        if layer == self.num_layers - 1:
            self.fetch_finished_s = time.perf_counter()

    def _on_task_done(self, task):
        if not task.cancelled() and task.exception() is not None:
            self._cancel_rest()
        self._live -= 1
        if self._live == 0:
            self._drained.set()
            self._maybe_release()

    # -- lifecycle -----------------------------------------------------------

    def _cancel_rest(self):
        """Stop refilling regions and write off layers that never staged.
        Layers that DID stage stay readable: a later install() may still
        read them, so they are written off only by install()'s abort paths
        or discard()."""
        if self._cancelled:
            return
        self._cancelled = True
        for fut in self._staged:
            if not fut.done():
                fut.cancel()
        for layer, ev in enumerate(self._consumed):
            fut = self._staged[layer]
            staged_ok = fut.done() and not fut.cancelled() and fut.exception() is None
            if layer not in self._installing and not staged_ok:
                ev.set()

    def _write_off_uninstalled(self):
        """Mark every layer the device will never read as consumed (only
        when no further install reads can happen)."""
        for layer, ev in enumerate(self._consumed):
            if layer not in self._installing:
                ev.set()
        self._maybe_release()

    def _maybe_release(self):
        if (self._lease is not None and self._drained.is_set()
                and all(ev.is_set() for ev in self._consumed)):
            self._lease.release()

    @property
    def wasted_blocks(self) -> int:
        """Blocks fetched into staging that never reached the device
        (meaningful once the prefetch settled)."""
        return max(0, self.blocks_fetched - self.blocks_installed)

    def promote(self) -> None:
        """Upgrade the remaining fetch to FOREGROUND class (the engine calls
        this when the request is admitted). Idempotent."""
        self._pri_cell["value"] = wire.PRIORITY_FOREGROUND

    async def primed(self) -> None:
        """Wait (gate-free) until every staging region holds a layer, or
        every layer is staged, whichever is less. Store errors do not raise
        here; they surface from :meth:`install`."""
        if self.n_blocks == 0:
            return
        await asyncio.wait([self._staged[min(self.num_layers, self.regions) - 1]])

    async def discard(self) -> None:
        """Cancel the prefetch and return every staging slot to the pool.
        Safe at any point except concurrently with install(); counts the
        staged-but-never-installed bytes as waste. Idempotent."""
        self._discarded = True
        self._cancel_rest()
        self._write_off_uninstalled()
        await self._drained.wait()
        for ev in self._consumed:
            await ev.wait()
        if self._lease is not None:
            self._lease.release()

    # -- install phase (device; caller holds its cache-mutation discipline) --

    def _host_kv(self, off: int, layers: int) -> torch.Tensor:
        n = self.n_blocks
        span = self.pool.buf[off : off + layers * self._region_bytes]
        return (torch.from_numpy(span).view(self.spec.dtype)
                .reshape((layers * 2 * n, *self.spec.block_shape)))

    def _mark_consumed(self, layers, done, loop):
        """Mark regions consumed once the device holds their bytes: at once
        on CPU (the scatter already copied them), after the upload's CUDA
        event on CUDA, waited for in an executor so the event loop never
        blocks on it."""

        def mark():
            for layer in layers:
                self._consumed[layer].set()
            self._maybe_release()

        if done is None:
            mark()
            return

        def wait_and_mark():
            done.synchronize()
            try:
                loop.call_soon_threadsafe(mark)
            except RuntimeError:
                # Loop closed at teardown: nothing will reuse the regions;
                # release the lease directly so the pool is never leaked.
                mark()

        loop.run_in_executor(None, wait_and_mark)

    def _upload_and_scatter(self, caches, ids_dev, kv_host):
        """Upload one span of staged layers and scatter it into the caches,
        every layer's K and V at once (K2 on CUDA: the packed span is
        ``[layer 0 K | layer 0 V | layer 1 K | ...]``, the layout of
        ``scatter_blocks_many``). Returns (the per-layer caches, the upload's
        event or None on CPU)."""
        device = caches[0][0].device
        if device.type == "cuda":
            kv_dev = kv_host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        else:
            kv_dev, done = kv_host, None
        flat = scatter_blocks_many([t for kv in caches for t in kv], ids_dev, kv_dev)
        return [tuple(flat[2 * i : 2 * i + 2]) for i in range(len(caches))], done

    async def install(self, caches, block_ids: np.ndarray, on_layer=None):
        """Scatter the staged prefix into the engine's paged cache, in place;
        returns ``(caches, blocks_loaded)`` with :meth:`KVConnector.load`'s
        semantics (raced-away blocks -> partial caches and 0 loaded;
        ``on_layer`` fires per layer in order).

        The only phase that needs the engine's exclusive cache gate. When
        every layer sits staged in back-to-back regions, the whole prefix
        rides ONE host-to-device upload."""
        if self._discarded:
            raise PrefetchDiscarded("install() after discard()")
        out = list(caches)
        if self.n_blocks == 0:
            return out, 0
        n = self.n_blocks
        if len(block_ids) != n:
            raise ValueError(
                f"install needs exactly the {n} fetched blocks' placement, "
                f"got {len(block_ids)} block ids"
            )
        if len(caches) != self.num_layers:
            raise ValueError(
                f"cache list has {len(caches)} layers, prefetch fetched {self.num_layers}"
            )
        ids_dev = _block_ids_on(block_ids, caches[0][0].device)
        loop = asyncio.get_running_loop()
        fused = (
            self.regions >= self.num_layers
            and self._region_stride == self._region_bytes
            and all(f.done() and not f.cancelled() and f.exception() is None
                    for f in self._staged)
        )
        if fused:
            # The device work runs in an executor so the event loop (every
            # other request's fetch completions) never stalls behind it;
            # the caller's gate still serializes the cache mutation.
            kv_host = self._host_kv(self._lease.offset, self.num_layers)
            scattered, done = await loop.run_in_executor(
                None, self._upload_and_scatter, list(out), ids_dev, kv_host)
            for layer in range(self.num_layers):
                out[layer] = scattered[layer]
                self._installing.add(layer)
                self.blocks_installed += 2 * n
                if on_layer is not None:
                    on_layer(layer, out[layer])
            self._mark_consumed(list(range(self.num_layers)), done, loop)
            return out, n
        for layer in range(self.num_layers):
            try:
                await asyncio.shield(self._staged[layer])
            except asyncio.CancelledError:
                if not self._staged[layer].cancelled():
                    raise  # the INSTALLING task was cancelled, not the fetch
                # A deeper layer's store failure cancels shallower pending
                # futures: surface that first error's semantics.
                self._write_off_uninstalled()
                err = self._error
                if err is None:
                    raise PrefetchDiscarded(f"prefetch discarded before layer {layer}")
                if isinstance(err, (InfiniStoreKeyNotFound, InfiniStoreResourcePressure)):
                    return out, 0
                raise PartialReadError(out, err) from err
            except (InfiniStoreKeyNotFound, InfiniStoreResourcePressure):
                # Blocks raced away or the store shed load: a miss, the
                # engine recomputes. Layers already scattered were written
                # in place, so the partial list is the only valid one.
                self._cancel_rest()
                self._write_off_uninstalled()
                return out, 0
            except Exception as e:
                self._cancel_rest()
                self._write_off_uninstalled()
                raise PartialReadError(out, e) from e
            if self._lease is None or self._lease._released:
                # Never read staging memory after the lease went back to the
                # pool: treat it as the miss it semantically is.
                return out, 0
            kv_host = self._host_kv(self._region_offset(layer), 1)
            (out[layer],), done = await loop.run_in_executor(
                None, self._upload_and_scatter, [out[layer]], ids_dev, kv_host)
            self._installing.add(layer)
            self.blocks_installed += 2 * n
            if on_layer is not None:
                on_layer(layer, out[layer])
            self._mark_consumed([layer], done, loop)
        return out, n
