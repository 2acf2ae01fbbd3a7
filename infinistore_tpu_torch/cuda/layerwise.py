"""Layer-wise streaming of paged KV blocks between device memory and the
store (port of ``infinistore_tpu/tpu/layerwise.py``; ``LayerwisePrefetch``
is not ported yet).

The store's latency trick: stream the KV cache layer by layer so network
transfer overlaps per-layer work. Device-to-host copies (on a side stream)
and network puts (up to ``depth`` layers in flight) are pipelined, and the
writer ships directly from the pinned buffers the copies land in.

Key naming follows the hash-chain convention: one key per (request-chain
hash, layer, k/v, block index), so ``get_match_last_index`` gives
longest-prefix reuse across requests.
"""

import asyncio
from collections import deque
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .. import wire
from ..lib import InfiniStoreException
from .paged import PagedKVCacheSpec, gather_blocks, scatter_blocks
from .staging import HostStagingPool

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
                k_cache, v_cache = caches[layer]
                # K blocks then V blocks packed into ONE tensor -> one
                # device-to-host copy per layer.
                staged.append((pos, layer, pool.stage_out([
                    torch.cat([
                        gather_blocks(k_cache, ids_dev),
                        gather_blocks(v_cache, ids_dev),
                    ])
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
                k_cache, v_cache = out[layer]
                out[layer] = (
                    scatter_blocks(k_cache, ids_dev, kv_dev[:n]),
                    scatter_blocks(v_cache, ids_dev, kv_dev[n:]),
                )
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
